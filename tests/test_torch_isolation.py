"""The port stands alone: it imports neither JAX nor the JAX package.

Each check runs a fresh interpreter in which ``import jax`` and ``import
nonuniformffts_tpu`` fail, so that a stray import anywhere in the port (or
in ``chip_smoke.py``) shows as an ImportError instead of passing because
the test process happens to have JAX loaded.
"""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "nonuniformffts_tpu")

_BLOCKER = textwrap.dedent(f"""
    import importlib.abc, sys
    class _Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in {BLOCKED!r}:
                raise ImportError(f"{{name}} is blocked in this test")
            return None
    sys.meta_path.insert(0, _Block())
    sys.path.insert(0, {str(ROOT)!r})
""")

_DRIVE = textwrap.dedent("""
    import itertools, sys
    import numpy as np
    import nonuniformffts_tpu_torch as nufft
    rng = np.random.default_rng(0)
    for dtype, shape in itertools.product(
            (np.complex64, np.complex128, np.float32, np.float64),
            ((8,), (8, 8), (8, 8, 8))):
        real = np.dtype(dtype).type(0).real.dtype
        plan = nufft.PlanNUFFT(dtype, shape, m=3, sigma=2.0,
                               spread_method="blocked", device="cpu")
        plan = nufft.set_points(plan, rng.uniform(0, 7, (len(shape), 30)).astype(real))
        v = rng.standard_normal(30).astype(dtype)
        u = nufft.exec_type1(plan, v)
        assert tuple(u.shape) == plan.spectral_shape
        assert nufft.exec_type2(plan, u).dtype == plan.dtype
    for window in sorted(nufft.WINDOWS):
        p = nufft.plan_nfft(rng.uniform(-0.5, 0.5, (2, 30)), (8, 8), window=window,
                            reltol=1e-6, device="cpu", spread_method="blocked")
        assert tuple((p.H @ (p @ np.ones((8, 8), np.complex128))).shape) == (8, 8)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not bad, bad
    print("ISOLATED OK")
""")


def _run(code: str, *args, timeout=240):
    return subprocess.run(
        [sys.executable, "-c", _BLOCKER + f"BLOCKED = {BLOCKED!r}\n" + code, *args],
        capture_output=True, text=True, cwd=ROOT, timeout=timeout,
    )


def test_port_runs_without_jax():
    res = _run(_DRIVE)
    assert res.returncode == 0, res.stderr
    assert "ISOLATED OK" in res.stdout


def _imported_modules(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("__import__", "import_module"):
            names.update(a.value for a in node.args if isinstance(a, ast.Constant))
    return names


@pytest.mark.parametrize(
    "path",
    [ROOT / "chip_smoke.py", ROOT / "chip_probe.py",
     *sorted((ROOT / "nonuniformffts_tpu_torch").rglob("*.py"))],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_sources_import_no_jax(path):
    names = _imported_modules(path)
    assert not [n for n in names if n.split(".")[0] in BLOCKED], names


def test_chip_smoke_fails_without_a_card():
    """Without CUDA the chip check exits non-zero and prints no result."""
    code = ("import runpy, sys\nsys.argv = ['chip_smoke.py']\n"
            f"runpy.run_path({str(ROOT / 'chip_smoke.py')!r}, run_name='__main__')\n")
    res = _run(code)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout and '"kernels"' not in res.stdout
