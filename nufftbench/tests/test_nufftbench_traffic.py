"""The traffic generator: the same seed gives the same inputs, every seed
the same sizes, and a moving mix's displacement stays within its cells."""

import math

import pytest
import torch

from nufftbench.shapes import shapes_of
from nufftbench.traffic import Traffic

CONFIG = {"shape": [12, 10, 16], "dtype": "complex128", "m": 4, "sigma": 1.5,
          "kernel": "BackwardsKaiserBesselKernel", "kernel_evalmode": "FastApproximation"}
MOVING = {"density": 0.5, "motion": "moving", "max_displacement_cells": 1.0,
          "execs": ["exec_type1", "exec_type2"], "ntransforms": 2}
FIXED = {"density": 0.5, "motion": "fixed", "execs": ["exec_type1", "exec_type2"],
         "ntransforms": 1}
BIG_SEED = 2**31 + 987_654_321


def _tensors(t: Traffic):
    return [t.x0, t.disp, t.values, t.spectrum, t.points(7)]


@pytest.mark.parametrize("mix", [MOVING, FIXED], ids=["moving", "fixed"])
@pytest.mark.parametrize("dtype", ["complex128", "float64"])
def test_same_seed_same_inputs(mix, dtype):
    cfg = dict(CONFIG, dtype=dtype)
    a, b = Traffic(cfg, mix, BIG_SEED, "cpu"), Traffic(cfg, mix, BIG_SEED, "cpu")
    for x, y in zip(_tensors(a), _tensors(b)):
        if x is None:
            assert y is None
        else:
            assert torch.equal(x, y)


def test_seeds_change_draws_not_sizes():
    a, b = Traffic(CONFIG, MOVING, 1, "cpu"), Traffic(CONFIG, MOVING, 2, "cpu")
    for x, y in zip(_tensors(a), _tensors(b)):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert not torch.equal(x, y)


def test_sizes_follow_config_and_mix():
    t = Traffic(CONFIG, MOVING, 3, "cpu")
    npts = round(0.5 * 12 * 10 * 16)
    assert t.x0.shape == (3, npts) and t.x0.dtype == torch.float64
    assert t.values.shape == (2, npts) and t.values.dtype == torch.complex128
    assert t.spectrum.shape == (2, 12, 10, 16)
    real = Traffic(dict(CONFIG, dtype="float64"), MOVING, 3, "cpu")
    assert real.values.dtype == torch.float64
    assert real.spectrum.shape == (2, 12, 10, 9)
    assert shapes_of(CONFIG, MOVING).num_points == npts
    assert bool(((t.x0 >= 0) & (t.x0 < 2 * math.pi)).all())


def test_displacement_within_a_cell_and_linear_in_steps():
    t = Traffic(CONFIG, MOVING, 4, "cpu")
    cells = torch.tensor([2 * math.pi / n for n in CONFIG["shape"]], dtype=torch.float64)
    assert bool((t.disp.abs() <= cells[:, None]).all())
    # spread over the whole cell, both signs
    assert float(t.disp.abs().max()) > 0.9 * float(cells.min())
    assert bool((t.disp < 0).any()) and bool((t.disp > 0).any())
    assert torch.equal(t.points(0), t.x0)
    assert torch.allclose(t.points(300), t.x0 + 300 * t.disp, rtol=0, atol=1e-12)
    # points leave [0, 2 pi): the program folds them
    assert float(t.points(300).max()) > 2 * math.pi or float(t.points(300).min()) < 0


def test_fixed_points_do_not_move():
    t = Traffic(CONFIG, FIXED, 5, "cpu")
    assert t.disp is None
    assert t.points(0) is t.points(123)
