"""The port's overlap-add assembly over a mesh (parallel/mesh.py) against the
JAX package's on the CPU, its padded lanes and refusals; the repaired
single-device overlap_add (data/patcher.py: box adds in tile order, no
atomic scatter); and make_mesh's refusal to take fewer devices than asked."""
import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu.data.patcher import flat_index_map
from deep_prior_interpolation_tpu.parallel import make_mesh as jax_make_mesh
from deep_prior_interpolation_tpu.parallel import overlap_add_sharded as jax_overlap_add_sharded
from deep_prior_interpolation_tpu_torch.data import overlap_add
from deep_prior_interpolation_tpu_torch.parallel import make_mesh, overlap_add_sharded

torch.set_num_threads(1)
CPU8 = [torch.device("cpu")] * 8
TILINGS = [
    # (image_shape, dim, stride): 8 and 16 patches, overlapping and exact
    ((16, 16, 32), (16, 8, 8), (16, 8, 8)),     # 8 exact tiles, 3D
    ((8, 36), (8, 8), (8, 4)),                   # 8 tiles overlapping in x
    ((20, 20), (8, 8), (4, 4)),                  # 16 overlapping tiles, 2D
]


def _numpy_overlap_add(patches, image_shape, dim, stride):
    """float64 overlap-add averaged over the counts, by flat indices."""
    idx = flat_index_map(image_shape, dim, stride)
    flat = np.zeros(int(np.prod(image_shape)))
    counts = np.zeros_like(flat)
    np.add.at(flat, idx.ravel(), patches.astype(np.float64).reshape(-1))
    np.add.at(counts, idx.ravel(), 1.0)
    return (flat / np.maximum(counts, 1.0)).reshape(image_shape)


@pytest.mark.parametrize("tiling", TILINGS)
def test_overlap_add_sharded_matches_jax(tiling):
    image_shape, dim, stride = tiling
    n = flat_index_map(image_shape, dim, stride).shape[0]
    patches = np.random.RandomState(n).randn(n, *dim).astype(np.float32)
    got = overlap_add_sharded(patches, image_shape, dim, stride, make_mesh(8, CPU8))
    want = jax_overlap_add_sharded(patches, image_shape, dim, stride, jax_make_mesh(8))
    assert got.shape == tuple(image_shape) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), _numpy_overlap_add(patches, *tiling),
                               rtol=1e-6, atol=1e-6)
    again = overlap_add_sharded(patches, image_shape, dim, stride, make_mesh(8, CPU8))
    assert torch.equal(got, again)


def test_overlap_add_sharded_padded_lanes_and_refusals():
    """A 6-tile tiling padded with 2 zero patches for an 8-lane mesh: the
    zero lanes add nothing and no coverage; non-zero padding, a count that
    is not a multiple of the mesh and fewer patches than tiles raise."""
    image_shape, dim, stride = (8, 28), (8, 8), (8, 4)
    real = np.random.RandomState(6).randn(6, *dim).astype(np.float32)
    padded = np.concatenate([real, np.zeros((2,) + dim, np.float32)])
    mesh = make_mesh(8, CPU8)
    got = overlap_add_sharded(padded, image_shape, dim, stride, mesh)
    want = jax_overlap_add_sharded(padded, image_shape, dim, stride, jax_make_mesh(8))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    bad = np.concatenate([real, np.ones((2,) + dim, np.float32)])
    with pytest.raises(AssertionError, match="zero padding"):
        overlap_add_sharded(bad, image_shape, dim, stride, mesh)
    with pytest.raises(AssertionError, match="multiple of mesh size"):
        overlap_add_sharded(np.zeros((6, 4, 4), np.float32), (8, 8), (4, 4), (4, 4), mesh)
    with pytest.raises(AssertionError, match="tiling implies"):
        overlap_add_sharded(np.zeros((8, 4, 4), np.float32), (16, 16), (4, 4), (4, 4), mesh)


def test_overlap_add_sharded_unnormalised_sums_in_device_order():
    image_shape, dim, stride = (20, 20), (8, 8), (4, 4)
    patches = np.random.RandomState(2).randn(16, *dim).astype(np.float32)
    got = overlap_add_sharded(patches, image_shape, dim, stride, make_mesh(4, CPU8),
                              normalize=False)
    idx = flat_index_map(image_shape, dim, stride)
    flat = np.zeros(400)
    np.add.at(flat, idx.ravel(), patches.astype(np.float64).reshape(-1))
    np.testing.assert_allclose(got.numpy(), flat.reshape(image_shape), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tiling", TILINGS[1:])
def test_overlap_add_sums_in_tile_order(tiling):
    """The repaired overlap_add: box adds in tile order (no index_add_, an
    atomic scatter on a card), within 1e-6 of float64 and bit-equal from
    call to call."""
    image_shape, dim, stride = tiling
    n = flat_index_map(image_shape, dim, stride).shape[0]
    patches = torch.from_numpy(np.random.RandomState(n).randn(n, *dim).astype(np.float32))
    got = overlap_add(patches, image_shape, dim, stride)
    np.testing.assert_allclose(got.numpy(), _numpy_overlap_add(patches.numpy(), *tiling),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(got, overlap_add(patches, image_shape, dim, stride))


def test_make_mesh_refuses_more_devices_than_exist(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_mesh(2) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert make_mesh() == make_mesh(2)
    with pytest.raises(RuntimeError, match="3 CUDA devices was asked for and 2 exist"):
        make_mesh(3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="1 CUDA devices was asked for and 0 exist"):
        make_mesh(1)
    with pytest.raises(RuntimeError, match="at least one device"):
        make_mesh()
    assert make_mesh(2, CPU8) == CPU8[:2]
    with pytest.raises(RuntimeError, match="9 devices was asked for and 8 were given"):
        make_mesh(9, CPU8)
