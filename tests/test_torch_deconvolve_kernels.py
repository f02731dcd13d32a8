"""The deconvolution kernels' index maps and arithmetic on the CPU.

``csrc/deconvolve.cu`` runs only on the card; its Python mirror
(``ops/kernels/common.py``: ``deconvolve_axes``, ``source_index``,
``mode_index``, ``truncate_sources``, ``pad_sources``) names the element
each output reads, or the zero it writes.
An emulation of both kernels in float64 (gather through the mirror, then
each component times the factors in the kernels' order) is held to the
plain torch chain (``truncate_axis`` / ``pad_axis`` and the multiplies) and
to the JAX package's ``ops/deconvolve.py`` over D = 1-3, even and odd
sizes, FFTW order and ``fftshift``, complex and real-data (r2c) spectra and
1 or 3 transforms.  The CPU path itself launches nothing and computes what
it computed before the kernels existed.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonuniformffts_tpu_torch as tnufft
from nonuniformffts_tpu.ops import deconvolve as j_deconvolve
from nonuniformffts_tpu_torch import execution as ex
from nonuniformffts_tpu_torch.callbacks import apply_uniform_callback
from nonuniformffts_tpu_torch.ops import deconvolve
from nonuniformffts_tpu_torch.ops.kernels import blocked, build, common
from nonuniformffts_tpu_torch.ops.kernels import deconvolve as kernels

torch.set_num_threads(1)

SHAPES = [(16,), (15,), (12, 10), (9, 7), (8, 6, 10), (7, 5, 9)]


def _ranges(shape, fftshift: bool, real: bool):
    """Index ranges and oversampled spectral shape of a plan over ``shape``
    with an oversampled axis of ``n + n // 2 + 1`` (odd and even extents),
    built as ``plan.py`` builds them."""
    ranges, over = [], []
    for d, n in enumerate(shape):
        r2c = real and d == len(shape) - 1
        n_over = n + n // 2 + 1
        k = deconvolve.output_wavenumbers(n, r2c=r2c, fftshift=fftshift and not r2c)
        n_over_spec = n_over // 2 + 1 if r2c else n_over
        ranges.append(deconvolve.truncate_ranges(len(k), n_over_spec, r2c=r2c,
                                                 fftshift=fftshift and not r2c))
        over.append(n_over_spec)
    return tuple(ranges), tuple(over)


def _case(shape, fftshift, real, C, seed=0):
    rng = np.random.default_rng(seed)
    ranges, over = _ranges(shape, fftshift, real)
    out = tuple(sum(l for _, l in r) for r in ranges)

    def spectrum(s):
        return torch.from_numpy(rng.standard_normal(s) + 1j * rng.standard_normal(s))

    phihat_inv = tuple(torch.from_numpy(rng.uniform(0.5, 3.0, n)) for n in out)
    return spectrum((C,) + over), spectrum((C,) + out), ranges, over, phihat_inv, 0.37


def _axis_factors(phihat_inv):
    """The factors of the kernels' three axes: 1 on a missing axis."""
    ones = [torch.ones(1, dtype=torch.float64)] * (3 - len(phihat_inv))
    return ones + list(phihat_inv)


def _along(f, d):
    """``f`` shaped to broadcast along axis ``d`` of ``(C', n0, n1, n2, 2)``."""
    return f.reshape([1] * (1 + d) + [-1] + [1] * (3 - d))


def emulate_truncate(uhat_over, ranges, phihat_inv, normfactor):
    """The truncate kernel in float64: each output reads its source through
    ``truncate_sources`` and each component is multiplied by normfactor,
    then the factors of axis 0, 1, 2."""
    axes = common.deconvolve_axes(ranges, uhat_over.shape[1:])
    C = uhat_over.shape[0]
    src = common.truncate_sources(axes)
    x = torch.view_as_real(uhat_over.reshape(C, -1)[:, src.reshape(-1)].reshape((C,) + axes.out))
    x = x * normfactor
    for d, f in enumerate(_axis_factors(phihat_inv)):
        x = x * _along(f, d)
    return torch.view_as_complex(x.contiguous()).reshape((C,) + axes.out[3 - len(ranges):])


def emulate_pad(modes, over, ranges, phihat_inv=None):
    """The pad kernel in float64: each element reads its mode through
    ``pad_sources`` and, when factors are given, each component is
    multiplied by those of axis 0, 1, 2 at its mode; or it is zero."""
    axes = common.deconvolve_axes(ranges, over)
    C = modes.shape[0]
    src = common.pad_sources(axes)
    x = torch.view_as_real(modes.reshape(C, -1)[:, src.clamp(min=0).reshape(-1)]
                           .reshape((C,) + axes.over))
    if phihat_inv is not None:
        for d, f in enumerate(_axis_factors(phihat_inv)):
            x = x * _along(f[common.mode_index(axes, d).clamp(min=0)], d)
    x = torch.where((src >= 0)[None, ..., None], x, torch.zeros((), dtype=x.dtype))
    return torch.view_as_complex(x.contiguous()).reshape((C,) + tuple(over))


GRID = [(shape, fftshift, real, C) for shape in SHAPES for fftshift in (False, True)
        for real in (False, True) for C in (1, 3)]
GRID_IDS = [f"{'x'.join(map(str, s))}-{'shift' if f else 'fftw'}-{'r2c' if r else 'c2c'}-C{C}"
            for s, f, r, C in GRID]


@pytest.mark.parametrize("shape,fftshift,real,C", GRID, ids=GRID_IDS)
def test_emulated_kernels_equal_plain_chain(shape, fftshift, real, C):
    """Both kernels' index maps and products, emulated, equal the plain
    chain bit for bit: the truncation alone against ``truncate_axis``, the
    padding alone against ``pad_axis``, and the scaled passes against
    ``deconvolve_truncate_plain`` / ``deconvolve_pad_plain`` and the
    unscaled pad of a grouped type 2 against ``pad_modes_plain``."""
    uhat_over, modes, ranges, over, phihat_inv, nf = _case(shape, fftshift, real, C)
    ones = tuple(torch.ones_like(p) for p in phihat_inv)
    cut = uhat_over
    for d, r in enumerate(ranges):
        cut = deconvolve.truncate_axis(cut, 1 + d, r)
    assert torch.equal(emulate_truncate(uhat_over, ranges, ones, 1.0), cut)
    padded = modes
    for d, r in enumerate(ranges):
        padded = deconvolve.pad_axis(padded, 1 + d, r, over[d])
    assert torch.equal(emulate_pad(modes, over, ranges), padded)
    assert torch.equal(emulate_pad(modes, over, ranges), deconvolve.pad_modes_plain(
        modes, over, ranges))
    assert torch.equal(emulate_truncate(uhat_over, ranges, phihat_inv, nf),
                       deconvolve.deconvolve_truncate_plain(uhat_over, ranges, phihat_inv, nf))
    assert torch.equal(emulate_pad(modes, over, ranges, phihat_inv),
                       deconvolve.deconvolve_pad_plain(modes, over, ranges, phihat_inv))


@pytest.mark.parametrize("shape,fftshift,real,C", GRID, ids=GRID_IDS)
def test_emulated_kernels_match_jax_package(shape, fftshift, real, C):
    """The emulated kernels against the JAX package's ``deconvolve_truncate``
    and ``deconvolve_pad`` on the same spectra, ranges and factors, with the
    JAX package's own ranges (``non_oversampled_indices`` structure)."""
    uhat_over, modes, ranges, over, phihat_inv, nf = _case(shape, fftshift, real, C, seed=1)
    j_ranges = tuple(
        j_deconvolve.truncate_ranges(sum(l for _, l in r), n, r2c=real and d == len(shape) - 1,
                                     fftshift=fftshift and not (real and d == len(shape) - 1))
        for d, (r, n) in enumerate(zip(ranges, over)))
    assert j_ranges == ranges
    j_ph = [jnp.asarray(p.numpy()) for p in phihat_inv]
    want1 = np.asarray(j_deconvolve.deconvolve_truncate(jnp.asarray(uhat_over.numpy()), ranges,
                                                        j_ph, nf))
    want2 = np.asarray(j_deconvolve.deconvolve_pad(jnp.asarray(modes.numpy()), over, ranges,
                                                   j_ph))
    got1 = emulate_truncate(uhat_over, ranges, phihat_inv, nf).numpy()
    got2 = emulate_pad(modes, over, ranges, phihat_inv).numpy()
    np.testing.assert_allclose(got1, want1, rtol=1e-15, atol=0)
    np.testing.assert_allclose(got2, want2, rtol=1e-15, atol=0)
    assert np.array_equal(got2 == 0, want2 == 0)


@pytest.mark.parametrize(
    "ranges,over,value_bytes,vec",
    [((((0, 128), (256, 128)),) * 3, (384,) * 3, 8, 2),  # complex64 c2c at 256^3
     ((((0, 128), (256, 128)),) * 3, (384,) * 3, 16, 1),  # complex128: one value is 16 B
     ((((0, 128), (256, 128)),) * 2 + (((0, 129),),), (384, 384, 193), 8, 1),  # r2c, odd
     ((((0, 5), (11, 4)),), (15,), 8, 1),  # odd run length
     ((((12, 4), (0, 4)),), (16,), 8, 2),  # fftshift, even bounds
     ((((13, 3), (0, 4)),), (16,), 8, 1)],  # fftshift, an odd start
    ids=["c64", "c128", "r2c", "odd_len", "shift_even", "shift_odd"])
def test_vector_width_needs_even_last_axis(ranges, over, value_bytes, vec):
    """Two complex64 an access only where no pair straddles a run or a row
    and every pair starts 16-byte aligned."""
    assert common.deconvolve_vector(common.deconvolve_axes(ranges, over), value_bytes) == vec


def test_geometry_struct_matches_axes():
    """The ctypes struct the kernels read carries the axes, missing leading
    ones of length 1 with one run."""
    ranges = (((5, 3), (0, 4)), ((0, 6),))
    axes = common.deconvolve_axes(ranges, (12, 9))
    assert axes == common.DeconvolveAxes(out=(1, 7, 6), over=(1, 12, 9), start0=(0, 5, 0),
                                         len0=(1, 3, 6), start1=(0, 0, 0))
    geom = build.DeconvGeometry.of(3, axes)
    assert geom.transforms == 3
    assert [tuple(getattr(geom, f)) for f in axes._fields] == list(axes)


def _struct_axes(geom) -> common.DeconvolveAxes:
    """The axes the kernels read back from the ctypes struct."""
    return common.DeconvolveAxes(*(tuple(getattr(geom, f)) for f in common.DeconvolveAxes._fields))


@pytest.mark.parametrize(
    "rows, vec, refused",
    [((46340, 46340, 1), 1, False),  # 2,147,395,600 items: the last row count taken
     ((46341, 46341, 1), 1, True),  # 2,147,488,281 items
     ((1, 2**30 - 1, 257), 1, False),  # two chunks a row: 2^31 - 2 items
     ((1, 2**30, 257), 1, True),  # two chunks a row: 2^31 items
     ((1, 2**30, 512), 2, False),  # two complex64 an access: one chunk a row
     ((1297, 1297, 1297), 1, False)],  # a 1297^3 grid: 1297^2 rows of 6 chunks
    ids=["46340sq", "46341sq", "two_chunks_below", "two_chunks_at", "vec2", "1297cubed"])
@pytest.mark.parametrize("step", common.DECONVOLVE_STEPS)
def test_item_limit_counts_items_not_elements(step, rows, vec, refused):
    """The kernels refuse a step whose (row, chunk) items of one transform
    reach 2^31 - 1, read through the geometry struct they are given; the
    elements of a transform may pass 2^31 (element offsets are 64-bit)."""
    ranges = tuple(((0, n),) for n in rows)
    geom = build.DeconvGeometry.of(2, common.deconvolve_axes(ranges, rows))
    items = common.deconvolve_items(_struct_axes(geom), step, vec)
    chunks = -(-(rows[2] // vec) // common.DECONVOLVE_ITEM_VECS)
    assert items == rows[0] * rows[1] * chunks
    assert (items >= common.DECONVOLVE_MAX_ITEMS) == refused


def test_item_count_of_an_864_cubed_plan():
    """864^3 at sigma 1.5 (1296^3 over, 2.18e9 elements a transform):
    complex128 takes 1296^2 rows of 6 chunks each way, so the kernels take
    it; its elements would pass a 32-bit count."""
    plan = tnufft.PlanNUFFT(np.complex128, (864,) * 3, m=4, sigma=1.5, device="cpu")
    axes = _struct_axes(build.DeconvGeometry.of(
        1, common.deconvolve_axes(plan.index_ranges, plan.spectral_shape_over)))
    assert math.prod(axes.over) > 2**31
    assert common.deconvolve_vector(axes, 16) == 1
    assert common.deconvolve_items(axes, "truncate", 1) == 864 * 864 * 4
    assert common.deconvolve_items(axes, "pad", 1) == axes.over[0] * axes.over[1] * 6
    assert common.deconvolve_items(axes, "pad", 1) < common.DECONVOLVE_MAX_ITEMS


def test_wrapper_refuses_what_it_does_not_take():
    """``takes`` refuses CPU tensors and other devices than CUDA; the
    launchers raise on a CPU tensor and on ranges outside their axis."""
    x = torch.zeros((1, 4, 4), dtype=torch.complex128)
    assert not kernels.takes(x)
    assert not kernels.takes(torch.empty((1, 4), dtype=torch.complex64, device="meta"))
    ranges = (((0, 2), (3, 1)), ((0, 2), (3, 1)))
    with pytest.raises(ValueError, match="no deconvolution kernel"):
        kernels.truncate(x, ranges, None, 1.0)
    with pytest.raises(ValueError, match="do not fit"):
        kernels.pad(torch.zeros((1, 3, 3), dtype=torch.complex128), (4, 3), ranges)


def _old_truncate(spec, plan, callback):
    """The deconvolution of type 1 as it was written before the kernels."""
    out = spec
    for d, ranges in enumerate(plan.index_ranges):
        out = deconvolve.truncate_axis(out, 1 + d, ranges)
    out = out * plan.normfactor
    for d, ph in enumerate(plan.phihat_inv):
        shape = [1] * (plan.ndim + 1)
        shape[1 + d] = ph.shape[0]
        out = out * ph.reshape(shape)
    return apply_uniform_callback(out, callback)


def _old_pad(uhat, plan, callback, scale=True):
    """The deconvolution of type 2 as it was written before the kernels."""
    w = uhat
    if scale:
        for d, ph in enumerate(plan.phihat_inv):
            shape = [1] * (plan.ndim + 1)
            shape[1 + d] = ph.shape[0]
            w = w * ph.reshape(shape)
        w = apply_uniform_callback(w, callback)
    for d, ranges in enumerate(plan.index_ranges):
        w = deconvolve.pad_axis(w, 1 + d, ranges, plan.spectral_shape_over[d])
    return w


def _weights(w_tuple, idx):
    return tuple(w * (1.0 + 0.25 * idx[-1]) for w in w_tuple)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128, np.float32, np.float64],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", [(12,), (10, 7), (6, 8, 5)], ids=str)
def test_cpu_path_launches_nothing_and_is_unchanged(shape, dtype):
    """On CPU tensors the stages run the plain chain: no launch is counted,
    and each stage, with and without a uniform callback and the grouped
    pad, equals the chain as it was written before the kernels, bit for
    bit."""
    plan = tnufft.PlanNUFFT(dtype, shape, m=4, sigma=1.5, ntransforms=2, device="cpu")
    rng = np.random.default_rng(3)
    spec_shape = (2,) + plan.spectral_shape_over
    spec = torch.from_numpy(rng.standard_normal(spec_shape) + 1j * rng.standard_normal(spec_shape)
                            ).to(plan.complex_dtype)
    uhat_shape = (2,) + plan.spectral_shape
    uhat = torch.from_numpy(rng.standard_normal(uhat_shape) + 1j * rng.standard_normal(uhat_shape)
                            ).to(plan.complex_dtype)
    blocked.reset_launch_counts()
    for cb in (None, _weights):
        assert torch.equal(ex.t1_deconv_stage(plan, spec, cb), _old_truncate(spec, plan, cb))
        assert torch.equal(ex.t2_pad_stage(plan, uhat, cb), _old_pad(uhat, plan, cb))
    assert torch.equal(ex.t2_pad_modes_stage(plan, uhat), _old_pad(uhat, plan, None, False))
    assert not any(blocked.LAUNCHES.values())
