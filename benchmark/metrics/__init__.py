"""Per-layer metrics, one file each: ``<name>.py`` defines ``UNIT`` and
``read(rec)``, which returns the metric's value from the window's record and
the trace (``harness.Record``), or None where it finds nothing to read. The
harness loads every file here whose name does not start with ``_``."""
