"""The port's block-major <-> grid relayouts and channel API on the CPU
against the JAX package.

The relayouts (``ops/kernels/relayout.py``, the plain versions of K8a/K8b)
against JAX's Pallas copies ``relayout_to_grid_pallas`` /
``relayout_to_blocks_pallas`` in interpret mode and against their XLA twins
``relayout_to_grid`` / ``relayout_to_blocks``: copies, so equality is exact.
JAX's relayouts take real arrays; a complex tensor meets them in its channel
form ``(C, 2, ..)`` folded to ``CR = 2C``.  The channel API
(``exec_type{1,2}_channels``) against JAX's on one complex and one real plan,
tolerance 1e-10 (the same algorithm summed in another order).
"""

import numpy as np
import pytest
import torch

import nonuniformffts_tpu as jnufft
import nonuniformffts_tpu_torch as tnufft
from nonuniformffts_tpu.execution import exec_type1_channels as jax_t1_channels
from nonuniformffts_tpu.execution import exec_type2_channels as jax_t2_channels
from nonuniformffts_tpu.ops.pallas import common as jcommon
from nonuniformffts_tpu_torch.execution import (
    exec_type1_channels,
    exec_type2_channels,
    from_channels,
    to_channels,
)
from nonuniformffts_tpu_torch.ops.kernels import relayout
from torch_port_utils import random_points, rel_err

torch.set_num_threads(1)

# Block dims by D, two geometries each: the grid is nb * B with nb below.
GEOMETRIES = {
    1: [((8,), (3,)), ((5,), (1,))],
    2: [((4, 8), (2, 3)), ((6, 1), (1, 4))],
    3: [((2, 4, 8), (3, 2, 2)), ((3, 5, 4), (1, 3, 1))],
}
DTYPES = [np.float32, np.float64, np.complex64, np.complex128]


def _jax_form(x: torch.Tensor) -> np.ndarray:
    """Real channels, complex values folded to CR = 2C."""
    if not x.is_complex():
        return x.numpy()
    ch = to_channels(x, 1).numpy()
    return ch.reshape((-1,) + ch.shape[2:])


def _from_jax_form(a, like: torch.Tensor) -> torch.Tensor:
    a = torch.from_numpy(np.array(a))
    if not like.is_complex():
        return a
    return from_channels(a.reshape((like.shape[0], 2) + tuple(a.shape[1:])), 1)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("cr", [1, 3])
@pytest.mark.parametrize("geometry", [0, 1])
@pytest.mark.parametrize("D", [1, 2, 3])
def test_relayouts_equal_jax_pallas_and_xla(D, geometry, cr, dtype):
    blocks, block_dims = GEOMETRIES[D][geometry]
    grid_shape = tuple(nb * b for nb, b in zip(blocks, block_dims))
    rng = np.random.default_rng(D * 10 + geometry)
    x = rng.standard_normal((cr,) + grid_shape + (2,)).astype(np.dtype(dtype).type(0).real.dtype)
    g = torch.from_numpy(x[..., 0].copy() if np.dtype(dtype).kind == "f" else x)
    if np.dtype(dtype).kind == "c":
        g = torch.view_as_complex(g)

    b = relayout.relayout_to_blocks_plain(g, block_dims)
    assert tuple(b.shape) == (cr,) + blocks + block_dims
    assert torch.equal(relayout.relayout_to_blocks(g, block_dims), b)
    want_b = _jax_form(b)
    np.testing.assert_array_equal(
        np.asarray(jcommon.relayout_to_blocks_pallas(_jax_form(g), block_dims, interpret=True)),
        want_b)
    np.testing.assert_array_equal(
        np.asarray(jcommon.relayout_to_blocks(_jax_form(g), block_dims)), want_b)

    back = relayout.relayout_to_grid_plain(b, block_dims)
    assert torch.equal(back, g) and torch.equal(relayout.relayout_to_grid(b, block_dims), g)
    jg = jcommon.relayout_to_grid_pallas(want_b, block_dims, interpret=True)
    assert torch.equal(_from_jax_form(jg, g), g)
    assert torch.equal(_from_jax_form(jcommon.relayout_to_grid(want_b, block_dims), g), g)


# (grid shape with CR, block dims): 2D and 3D, CR 1-3, each run case: B2 < N2
# (runs of B2), B2 = N2 with B1 < N1 (runs of B1 B2), whole blocks.
RUN_SHAPES = [
    ((2, 6, 8, 9), (3, 4, 3)), ((3, 12, 10, 6), (4, 5, 3)), ((3, 8, 10), (4, 5)),
    ((1, 8, 12, 6), (4, 3, 6)), ((2, 6, 9), (3, 9)), ((1, 12, 10, 7), (4, 5, 7)),
    ((2, 8, 4, 6), (2, 4, 6)), ((3, 4, 7), (4, 7)), ((1, 6, 4, 5), (6, 4, 5)),
]
# Every relayout of the spatial mode's run at 256^3, n = 4 (chip_smoke.py
# phase 13): direction, grid shape with CR, block dims.
SPATIAL_SITES = {
    "type-1 pack": ("blocks", (1, 96, 256, 256), (96, 64, 256)),
    "type-2 unpack": ("grid", (1, 96, 256, 256), (96, 64, 256)),
    "type-1 gather unpack": ("grid", (1, 256, 256, 256), (256, 64, 256)),
    "type-1 dim-0 unshard": ("grid", (1, 64, 256, 256), (64, 64, 256)),
    "type-2 dim-0 pack": ("blocks", (1, 64, 256, 256), (64, 64, 256)),
}


def _run_copy(x: torch.Tensor, out_shape, geom, to_grid: bool) -> torch.Tensor:
    """The kernels' copy, run by run: run ``r`` of ``run_len`` elements at
    grid offset ``r run_len`` and block-major offset ``block_runs(r)
    run_len``."""
    src, out, L = x.reshape(-1), x.new_empty(out_shape), geom.run_len
    dst = out.view(-1)
    for r, b in enumerate(relayout.block_runs(geom, torch.arange(geom.runs)).tolist()):
        g, k = slice(r * L, (r + 1) * L), slice(b * L, (b + 1) * L)
        if to_grid:
            dst[g] = src[k]
        else:
            dst[k] = src[g]
    return out


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128], ids=str)
@pytest.mark.parametrize("grid_shape,block_dims", RUN_SHAPES, ids=str)
def test_run_copy_equals_plain_relayouts(grid_shape, block_dims, dtype):
    geom = relayout.run_geometry(grid_shape, block_dims)
    assert geom.runs * geom.run_len == np.prod(grid_shape)
    g = torch.randn(grid_shape, dtype=dtype, generator=torch.Generator().manual_seed(7))
    b = relayout.relayout_to_blocks_plain(g, block_dims)
    assert torch.equal(_run_copy(g, b.shape, geom, to_grid=False), b)
    assert torch.equal(_run_copy(b, g.shape, geom, to_grid=True), g)


def test_run_geometry_cases():
    """The longest stretch contiguous on both sides, by case."""
    assert relayout.run_geometry((2, 6, 8, 9), (3, 4, 3))[:2] == (2 * 6 * 8 * 3, 3)
    assert relayout.run_geometry((1, 8, 12, 6), (4, 3, 6))[:2] == (8 * 4, 18)
    assert relayout.run_geometry((2, 8, 4, 6), (2, 4, 6))[:2] == (2 * 4, 48)
    assert relayout.run_geometry((3, 4, 7), (4, 7))[:2] == (3, 28)


@pytest.mark.parametrize("site", sorted(SPATIAL_SITES))
def test_run_copy_at_spatial_call_sites(site):
    """Each relayout of the spatial mode at phase 13's size (runs of 64 x
    256 elements) as a run-by-run copy of element indices."""
    direction, grid_shape, block_dims = SPATIAL_SITES[site]
    geom = relayout.run_geometry(grid_shape, block_dims)
    assert geom.run_len == 64 * 256 and geom.runs == np.prod(grid_shape) // (64 * 256)
    idx = torch.arange(int(np.prod(grid_shape)), dtype=torch.int32).reshape(grid_shape)
    b = relayout.relayout_to_blocks_plain(idx, block_dims)
    if direction == "blocks":
        assert torch.equal(_run_copy(idx, b.shape, geom, to_grid=False), b)
    else:
        assert torch.equal(_run_copy(b, idx.shape, geom, to_grid=True), idx)


def test_relayout_rejects_mismatched_block_dims():
    g = torch.zeros((1, 8, 6))
    with pytest.raises(ValueError, match="must divide"):
        relayout.relayout_to_blocks(g, (3, 4))
    with pytest.raises(ValueError, match="do not match"):
        relayout.relayout_to_grid(relayout.relayout_to_blocks(g, (4, 3)), (3, 4))


def test_one_dim_relayout_is_a_free_reshape():
    g = torch.arange(24.0).reshape(2, 12)
    b = relayout.relayout_to_blocks(g, (4,))
    assert b.data_ptr() == g.data_ptr() and tuple(b.shape) == (2, 3, 4)
    assert relayout.relayout_to_grid(b, (4,)).data_ptr() == g.data_ptr()


@pytest.mark.parametrize("dtype", [np.complex128, np.float64], ids=lambda d: np.dtype(d).name)
def test_channel_api_matches_jax(dtype):
    rng = np.random.default_rng(5)
    shape, C, np_ = (12, 10, 8), 2, 300
    kw = dict(m=4, sigma=2.0, ntransforms=C)
    pts = random_points(rng, 3, np_, dtype)
    real = np.dtype(dtype).kind == "f"
    v_ch = rng.standard_normal((C, np_) if real else (C, 2, np_))
    tp = tnufft.set_points(tnufft.PlanNUFFT(dtype, shape, device="cpu", **kw), pts)
    jp = jnufft.set_points(jnufft.PlanNUFFT(dtype, shape, spread_method="reference",
                                            fft_method="xla", **kw), pts)
    u = exec_type1_channels(tp, v_ch)
    ju = np.asarray(jax_t1_channels(jp, v_ch))
    assert tuple(u.shape) == (C, 2) + tp.spectral_shape and u.dtype == torch.float64
    assert rel_err(u.numpy(), ju) <= 1e-10
    v2 = exec_type2_channels(tp, np.array(ju))
    jv2 = np.asarray(jax_t2_channels(jp, ju))
    assert tuple(v2.shape) == ((C, np_) if real else (C, 2, np_))
    assert rel_err(v2.numpy(), jv2) <= 1e-10
    # Without the component axis on a single-transform plan.
    tp1 = tnufft.set_points(tnufft.PlanNUFFT(dtype, shape, m=4, sigma=2.0, device="cpu"), pts)
    u1 = exec_type1_channels(tp1, v_ch[0])
    assert tuple(u1.shape) == (2,) + tp1.spectral_shape
    assert torch.allclose(u1, exec_type1_channels(tp1, v_ch[:1])[0])
    assert tuple(exec_type2_channels(tp1, u1).shape) == v_ch[0].shape
