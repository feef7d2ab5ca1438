"""The port's weights file is the JAX package's (io/msgpack.py ``packb``,
io/checkpoint.save_params, ``--savemodel``): ``<name>_model.msgpack``
holds the bytes ``flax.serialization.to_bytes`` writes for the bridged
tree; the JAX ``load_params`` reads it into its template bit for bit; a JAX
``cli.run --net load --netdir`` starts from a port run's file; the port
reads its own file back exactly. The encoder's forms are msgpack's own
(checked against the ``msgpack`` package), and what flax would not write
as one value is refused."""
import os

import flax.serialization
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu import cli as jax_cli
from deep_prior_interpolation_tpu import config as jcfg
from deep_prior_interpolation_tpu.engine import DIPSolver as JaxDIPSolver
from deep_prior_interpolation_tpu.io import load_params as jax_load_params
from deep_prior_interpolation_tpu_torch import Config, DIPSolver, cli
from deep_prior_interpolation_tpu_torch.config import parse_arguments
from deep_prior_interpolation_tpu_torch.data import dataset_path
from deep_prior_interpolation_tpu_torch.io import load_params, save_params
from deep_prior_interpolation_tpu_torch.io import msgpack as port_msgpack
from deep_prior_interpolation_tpu_torch.io import state_dict_to_jax_params
from deep_prior_interpolation_tpu_torch.models import init_weights

torch.set_num_threads(1)
LINES = os.path.dirname(dataset_path("lines/original.npy"))
NETS = [dict(datadim="2d", inputdepth=4, filters=[8, 16], skip=[4]),
        dict(datadim="3d", inputdepth=4, filters=[4, 8], skip=[4], upsample="linear"),
        dict(datadim="3d", inputdepth=4, filters=[4, 8], skip=[4], net="skip")]


def _state(kw, seed=0):
    model = DIPSolver(Config(**kw), device="cpu").model
    init_weights(model, torch.Generator().manual_seed(seed))
    return {k: v.clone() for k, v in model.state_dict().items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("kw", NETS)
def test_the_port_writes_flax_s_bytes_and_jax_reads_them_bit_for_bit(kw, tmp_path):
    state = _state(kw)
    path = str(tmp_path / "0_model.msgpack")
    save_params(path, state)
    tree = state_dict_to_jax_params(state)
    with open(path, "rb") as fh:
        data = fh.read()
    assert data == flax.serialization.to_bytes(tree)
    # the JAX package's reader, into a template of its own arrays
    got = jax_load_params(path, jax_tree_like(tree))
    want, read = dict(_leaves(tree)), dict(_leaves(got))
    assert read.keys() == want.keys()
    for k, w in want.items():
        a = np.asarray(read[k])
        assert a.dtype == np.float32 and a.shape == w.shape and a.tobytes() == w.tobytes(), k


def jax_tree_like(tree):
    return {k: jax_tree_like(v) if isinstance(v, dict) else jnp.zeros(v.shape, v.dtype)
            for k, v in tree.items()}


@pytest.mark.parametrize("kw", NETS[:2])
def test_port_to_msgpack_to_port_is_exact(kw, tmp_path):
    state = _state(kw, seed=3)
    path = str(tmp_path / "w.msgpack")
    save_params(path, state)
    back = load_params(path, state)
    assert back.keys() == state.keys()
    assert all(torch.equal(back[k], v) for k, v in state.items())
    with pytest.raises(KeyError, match="missing"):
        load_params(path, {**state, "extra.kernel": torch.zeros(1)})


def test_a_jax_run_starts_from_a_port_run_s_weights(tmp_path, monkeypatch):
    flags = ["--imgdir", LINES, "--imgname", "original.npy", "--maskname", "random66.npy",
             "--datadim", "2d", "--gain", "1", "--epochs", "1", "--scan_chunk", "1",
             "--inputdepth", "4", "--filters", "4", "8", "--skip", "4",
             "--patch_shape", "170", "100", "1", "--savemodel"]
    root = str(tmp_path / "results")
    cli.run(parse_arguments(flags + ["--outdir", "port"]), root, device="cpu")
    saved = load_params(os.path.join(root, "port", "0_model.msgpack"))

    seen = []
    real = JaxDIPSolver.solve

    def spy(self, *a, **k):
        seen.append(k.get("init_params"))
        return real(self, *a, **k)
    monkeypatch.setattr(JaxDIPSolver, "solve", spy)
    out = jax_cli.run(jcfg.parse_arguments(flags + [
        "--outdir", "jax", "--net", "load", "--netdir", "port/0_model.msgpack"]), root)
    assert os.path.exists(os.path.join(out, "0_run.npz")) and len(seen) == 1
    want = state_dict_to_jax_params(saved)
    got = dict(_leaves(seen[0]))
    assert got.keys() == dict(_leaves(want)).keys()
    for k, w in _leaves(want):
        assert np.asarray(got[k]).tobytes() == w.tobytes(), k
    # and the JAX run's own weights file reads back into the port
    back = load_params(os.path.join(out, "0_model.msgpack"), saved)
    assert back.keys() == saved.keys()


def test_the_encoder_s_forms_are_msgpack_s():
    for value in [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1, -1,
                  -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1, -2 ** 63, "", "a" * 31,
                  "a" * 32, "a" * 256, "é" * 40000, b"", b"x" * 256, b"x" * 70000,
                  list(range(15)), list(range(16)), list(range(70000)),
                  {str(i): i for i in range(15)}, {str(i): [i] for i in range(16)},
                  (3, "float32", b"\x00" * 12)]:
        assert port_msgpack.packb(value) == msgpack.packb(value, use_bin_type=True), value
    # arrays whose ext payloads take the 8-, 16- and 32-bit length headers
    for n in [1, 2, 3, 4, 8, 16, 17, 255, 256, 70000]:
        tree = {"a": np.arange(n, dtype=np.uint8), "b": np.zeros((n, 3), np.float64)}
        assert port_msgpack.packb(tree) == flax.serialization.to_bytes(tree), n
        back = port_msgpack.unpackb(port_msgpack.packb(tree))
        assert all(np.array_equal(back[k], v) and back[k].dtype == v.dtype
                   for k, v in tree.items())


def test_what_flax_would_not_write_as_one_value_is_refused(monkeypatch):
    with pytest.raises(TypeError, match="not a str"):
        port_msgpack.packb({1: np.zeros(1)})
    with pytest.raises(TypeError, match="float is not written"):
        port_msgpack.packb({"a": 1.5})
    with pytest.raises(TypeError, match="dtype object"):
        port_msgpack.packb({"a": np.array([None])})
    monkeypatch.setattr(port_msgpack, "_MAX_CHUNK", 16)
    with pytest.raises(ValueError, match="chunk"):
        port_msgpack.packb({"a": np.zeros(5, np.float32)})
