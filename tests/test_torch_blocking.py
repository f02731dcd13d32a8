"""Bin sort and block geometry of the PyTorch port: the stable sort's
permutation and per-block point ranges equal the JAX package's packed
layout (``blocking.packed_layout``) for the same block dims."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonuniformffts_tpu as jnufft
import nonuniformffts_tpu_torch as tnufft
from nonuniformffts_tpu.blocking import packed_layout
from nonuniformffts_tpu_torch import blocking
from nonuniformffts_tpu_torch.ops.kernels.common import (
    MAX_SMEM_BYTES,
    NUM_SMS,
    SM_SMEM_BYTES,
    SMEM_RESERVED_PER_CTA,
    SPREAD_CTAS_PER_SM,
    spread_smem_bytes,
)
from torch_port_utils import random_points

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize(
    "shape,block_dims",
    [((16, 16, 16), (8, 4, 12)), ((16, 12, 20), (6, 18, 10)), ((20, 24), (5, 12))],
)
def test_sort_matches_packed_layout(dtype, shape, block_dims):
    rng = np.random.default_rng(11)
    np_ = 700
    # Unfolded coordinates: the cell split folds them.
    pts = random_points(rng, len(shape), np_, dtype, lo=-2 * np.pi, hi=4 * np.pi)
    pts[:, :5] = np.float32(2 * np.pi)  # ties on the bin key
    jp = jnufft.PlanNUFFT(dtype, shape, m=4, sigma=1.5)
    tp = tnufft.PlanNUFFT(dtype, shape, m=4, sigma=1.5, spread_method="blocked",
                          block_dims=block_dims, device="cpu")
    out = packed_layout(jp.kernel_data, block_dims, jnp.asarray(pts), 128)
    tp = tnufft.set_points(tp, pts)
    np.testing.assert_array_equal(tp.sort_perm.numpy(), np.asarray(out[5])[:np_])
    np.testing.assert_array_equal(tp.pstarts.numpy(), np.asarray(out[1]))
    assert tp.sort_perm.dtype == torch.int64 and tp.pstarts.dtype == torch.int32

    # Sorted cells and fractions are the unsorted ones permuted, and every
    # block's range holds exactly its own points.
    cells, fracs = blocking.cells_and_fracs(tp.kernel_data, torch.from_numpy(pts))
    np.testing.assert_array_equal(tp.cells_sorted.numpy(), cells[:, tp.sort_perm].numpy())
    np.testing.assert_array_equal(tp.fracs_sorted.numpy(), fracs[:, tp.sort_perm].numpy())
    bid = blocking.block_ids_from_cells(tp.cells_sorted, tp.shape_over, block_dims)
    nb = blocking.num_blocks(tp.shape_over, block_dims)
    want = np.ravel_multi_index(
        tuple(tp.cells_sorted.numpy()[d] // block_dims[d] for d in range(len(nb))), nb
    )
    np.testing.assert_array_equal(bid.numpy(), want)
    ps = tp.pstarts.numpy()
    for b in range(len(ps) - 1):
        assert (want[ps[b]:ps[b + 1]] == b).all()


@pytest.mark.parametrize("shape_over,m", [((384, 384, 384), 4), ((96, 96, 96), 4),
                                          ((384, 384, 384), 8), ((30, 45, 60), 2)])
def test_choose_geometry_fits_hopper(shape_over, m):
    bd = blocking.choose_geometry(shape_over, m)
    assert len(bd) == len(shape_over)
    assert all(n % b == 0 for n, b in zip(shape_over, bd))
    assert spread_smem_bytes(bd, m, m + 4) <= MAX_SMEM_BYTES
    nblocks = int(np.prod(blocking.num_blocks(shape_over, bd)))
    if int(np.prod(shape_over)) >= 2 * NUM_SMS * 4096:
        assert nblocks >= 2 * NUM_SMS


def test_main_path_geometry():
    """At the benchmark point (grid 384^3, m = 4) three spread CTAs fit an
    SM's shared memory, at a halo ratio below 3.7."""
    bd = blocking.choose_geometry((384, 384, 384), 4)
    smem = spread_smem_bytes(bd, 4, 8)
    assert SM_SMEM_BYTES // (smem + SMEM_RESERVED_PER_CTA) >= SPREAD_CTAS_PER_SM
    padded = np.prod([b + 7 for b in bd])
    assert padded / np.prod(bd) < 3.7
