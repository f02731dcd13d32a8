"""Helpers shared by the ``test_torch_*.py`` files, which hold the PyTorch
port (``nonuniformffts_tpu_torch``) against the JAX package on the same
inputs, made with numpy from a seed."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import nonuniformffts_tpu as jnufft
import nonuniformffts_tpu_torch as tnufft

KERNEL_NAMES = (
    "KaiserBesselKernel",
    "BackwardsKaiserBesselKernel",
    "GaussianKernel",
    "BSplineKernel",
)
EVALMODE_NAMES = ("Direct", "FastApproximation")


def kernel_pair(name: str):
    """The same window kernel in both packages."""
    return getattr(tnufft, name)(), getattr(jnufft, name)()


def evalmode_pair(name: str):
    return getattr(tnufft, name)(), getattr(jnufft, name)()


def real_dtype(dtype) -> np.dtype:
    return np.dtype(dtype).type(0).real.dtype


def random_points(rng, D: int, np_: int, dtype, lo=0.0, hi=2 * np.pi) -> np.ndarray:
    """(D, Np) coordinates in the plan's real dtype."""
    return rng.uniform(lo, hi, (D, np_)).astype(real_dtype(dtype))


def random_complex(rng, dtype, shape) -> np.ndarray:
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def rel_err(a, b) -> float:
    a = np.asarray(a)
    b = np.asarray(b)
    return float(np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel()))


def jax_kernel_data_np(kd) -> dict:
    """A JAX ``KernelData``'s fields as numpy / floats."""
    out = {f.name: getattr(kd, f.name) for f in dataclasses.fields(kd)}
    for k in ("cs_poly", "cs_gauss", "cs_poly_lo"):
        if out[k] is not None:
            out[k] = np.asarray(out[k], np.float64)
    return out


def port_kernel_data_np(kd) -> dict:
    out = {f.name: getattr(kd, f.name) for f in dataclasses.fields(kd)}
    for k in ("cs_poly", "cs_gauss"):
        if out[k] is not None:
            out[k] = out[k].to(torch.float64).numpy()
    return out
