"""Spans of the port's solve and step, recorded in memory.

A span is a named interval of host time, stamped by ``time.time_ns()``: the
Unix clock of ``torch.profiler``'s Chrome trace (``baseTimeNanoseconds`` +
``ts`` µs), so a trace's kernels can be put down to the span that launched
them. The recorder is off by default; while off, ``span`` is one branch that
returns a shared do-nothing context. A span never touches the device.
``enable()``, then ``with span("step", "it", 3): ...``, then ``drain()``.
"""
import contextlib
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Union

on = False               # the recorder's switch: ``enable`` and ``disable``
records: List["Span"] = []
_ids = itertools.count(1)
_local = threading.local()
_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int          # the enclosing span's id on this thread, 0 at the top
    solve: int           # the id of the outermost span open on this thread
    thread: int          # the OS thread id, as the profiler's trace has it
    attrs: Dict[str, Union[int, str]]


class _Open:
    """A span while it is open; with ``record`` False it only stamps."""
    __slots__ = ("name", "attrs", "record", "start", "end", "seconds", "id", "parent",
                 "solve")

    def __init__(self, name: str, attrs: Dict[str, Union[int, str]], record: bool):
        self.name, self.attrs, self.record = name, attrs, record

    def __enter__(self) -> "_Open":
        if self.record:
            stack = _stack()
            self.id = next(_ids)
            self.parent = stack[-1].id if stack else 0
            self.solve = stack[0].solve if stack else self.id
            stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.time_ns()
        self.seconds = (self.end - self.start) * 1e-9
        if self.record:
            _stack().pop()
            records.append(Span(self.name, self.start, self.end, self.id, self.parent,
                                self.solve, threading.get_native_id(), self.attrs))


def _stack() -> List[_Open]:
    return _local.__dict__.setdefault("stack", [])


def span(name: str, key: str = "", value: Union[int, str] = 0):
    """Records ``name`` (and the attribute ``key``) while the recorder is on."""
    if not on:
        return _OFF
    return _Open(name, {key: value} if key else {}, True)


def timed(name: str, key: str = "", value: Union[int, str] = 0) -> _Open:
    """A span stamped whether or not the recorder is on, for a time the
    program keeps too (``seconds``, after the ``with``)."""
    return _Open(name, {key: value} if key else {}, on)


def attr(key: str, value: Union[int, str]) -> None:
    """Sets an attribute or counter of the innermost span open on this
    thread; nothing while the recorder is off."""
    if on and _stack():
        _stack()[-1].attrs[key] = value


def enable() -> None:
    global on
    on = True


def disable() -> None:
    global on
    on = False


def drain() -> List[Span]:
    """The finished spans, cleared from the recorder."""
    out = records[:]
    del records[:len(out)]
    return out
