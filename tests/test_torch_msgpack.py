"""The JAX package's ``.msgpack`` weights in the port (io/msgpack.py,
io/checkpoint.load_params): files written by the JAX ``save_params`` (flax's
msgpack) from a parameter tree of the JAX net's layout, read without flax,
every leaf bit-equal after the bridge; the subset flax writes (a bf16 leaf,
a chunked array, scalars), the refusals with their offsets, and ``cli.run
--netdir`` on a JAX run directory (its ``args.txt`` and weights written by
the JAX package). The trees are drawn by the port and bridged: the JAX
package's own ``init`` of a net takes ~20 s on the CPU."""
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu.config import Config as JaxConfig
from deep_prior_interpolation_tpu.config import write_args as jax_write_args
from deep_prior_interpolation_tpu.io import save_params as jax_save_params
from deep_prior_interpolation_tpu_torch import Config, DIPSolver, cli
from deep_prior_interpolation_tpu_torch.config import parse_arguments
from deep_prior_interpolation_tpu_torch.data import dataset_path
from deep_prior_interpolation_tpu_torch.io import load_checked, state_dict_to_jax_params
from deep_prior_interpolation_tpu_torch.io.msgpack import read_msgpack, unpackb
from deep_prior_interpolation_tpu_torch.models import init_weights

torch.set_num_threads(1)
LINES = os.path.dirname(dataset_path("lines/original.npy"))


def _weights(kw):
    """A net's state dict drawn by the port, and the same as a JAX tree."""
    model = DIPSolver(Config(**kw), device="cpu").model
    init_weights(model, torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    return state, state_dict_to_jax_params(state)


@pytest.mark.parametrize("kw", [
    dict(datadim="2d", inputdepth=4, filters=[8, 16], skip=[4]),
    dict(datadim="3d", inputdepth=4, filters=[4, 8], skip=[4], net="skip"),
])
def test_jax_save_params_reads_back_bit_for_bit(kw, tmp_path):
    state, params = _weights(kw)
    jax_save_params(str(tmp_path / "0_model.msgpack"), params)
    jax_write_args(str(tmp_path / "args.txt"), JaxConfig(**kw))
    got = load_checked("0_model.msgpack", Config(**kw), state, str(tmp_path))
    assert set(got) == set(state)
    assert all(got[k].dtype == torch.float32 and torch.equal(got[k], v)
               for k, v in state.items())
    # and the file's tree is the JAX tree, leaf for leaf
    tree = read_msgpack(str(tmp_path / "0_model.msgpack"))
    want = jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in jax.tree_util.tree_leaves_with_path(tree)] == [p for p, _ in want]
    assert all(np.array_equal(a, w) for a, (_, w) in
               zip(jax.tree_util.tree_leaves(tree), want))


def test_bfloat16_leaves_and_scalars():
    rng = np.random.RandomState(0)
    w = jnp.asarray(rng.randn(3, 5), jnp.bfloat16)
    tree = {"a": {"kernel": w, "s": np.float32(2.5)}, "n": None, "t": True, "i": -70000,
            "u": 2 ** 40, "f": 0.25, "txt": "x" * 40, "raw": b"\x00\x01"}
    got = unpackb(flax.serialization.msgpack_serialize(tree))
    k = got["a"]["kernel"]
    assert k.dtype == torch.bfloat16 and k.shape == (3, 5)
    assert np.array_equal(k.view(torch.int16).numpy(), np.asarray(w).view(np.int16))
    assert got["a"]["s"] == np.float32(2.5) and got["a"]["s"].dtype == np.float32
    assert {k: got[k] for k in ("n", "t", "i", "u", "f", "txt", "raw")} == \
        {"n": None, "t": True, "i": -70000, "u": 2 ** 40, "f": 0.25, "txt": "x" * 40,
         "raw": b"\x00\x01"}


def test_a_chunked_array_is_put_back_together(monkeypatch, tmp_path):
    arr = np.random.RandomState(1).randn(7, 11).astype(np.float32)
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)  # 16 floats a chunk
    data = flax.serialization.to_bytes({"k": arr, "b": jnp.asarray(arr, jnp.bfloat16)})
    (tmp_path / "c.msgpack").write_bytes(data)
    got = read_msgpack(str(tmp_path / "c.msgpack"))
    assert np.array_equal(got["k"], arr)
    assert torch.equal(got["b"], torch.from_numpy(arr).to(torch.bfloat16))


def test_what_flax_writes_but_weights_never_hold_is_refused():
    data = flax.serialization.msgpack_serialize({"z": 1 + 2j})
    with pytest.raises(ValueError, match="ext type 2 at offset 3"):
        unpackb(data)
    good = flax.serialization.to_bytes({"k": np.arange(6, dtype=np.float32)})
    with pytest.raises(ValueError, match="truncated at offset"):
        unpackb(good[:-5])
    with pytest.raises(ValueError, match=f"1 bytes after the value, at offset {len(good)}"):
        unpackb(good + b"\x00")
    with pytest.raises(ValueError, match="ext type 9"):
        unpackb(b"\x81\xa1k\xd4\x09\x00")


def test_cli_netdir_takes_a_jax_run_directory(tmp_path, monkeypatch):
    flags = ["--imgdir", LINES, "--imgname", "original.npy", "--maskname", "random66.npy",
             "--datadim", "2d", "--gain", "1", "--epochs", "2", "--scan_chunk", "2",
             "--inputdepth", "4", "--filters", "4", "8", "--skip", "4",
             "--patch_shape", "170", "100", "1"]
    from deep_prior_interpolation_tpu import config as jcfg
    jax_run = tmp_path / "results" / "jaxrun"
    jax_cfg = jcfg.parse_arguments(flags + ["--outdir", "jaxrun"])
    jax_write_args(str(jax_run / "args.txt"), jax_cfg)
    state, params = _weights(dict(datadim="2d", inputdepth=4, filters=[4, 8], skip=[4]))
    jax_save_params(str(jax_run / "0_model.msgpack"), params)

    seen = []
    real = DIPSolver.solve

    def spy(self, *a, **k):
        seen.append(k.get("init_params"))
        return real(self, *a, **k)
    monkeypatch.setattr(DIPSolver, "solve", spy)
    cfg = parse_arguments(flags + ["--outdir", "port", "--net", "load",
                                   "--netdir", "jaxrun/0_model.msgpack"])
    out = cli.run(cfg, str(tmp_path / "results"), device="cpu")
    assert os.path.exists(os.path.join(out, "0_run.npz")) and len(seen) == 1
    assert set(seen[0]) == set(state)
    assert all(torch.equal(seen[0][k], v) for k, v in state.items())
