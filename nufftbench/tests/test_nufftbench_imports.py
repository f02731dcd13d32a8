"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program.  Module names are compared by
their top-level name (the part before the first dot), whole: the program's
name begins with the JAX package's."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "nufftbench"
JAX_NAMES = {"jax", "jaxlib", "flax", "nonuniformffts_tpu"}
PROGRAM = "nonuniformffts_tpu_torch"


def _imported_top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_sources_import_no_jax(path):
    names = _imported_top_names(path)
    assert not names & JAX_NAMES
    if "references" in path.parts:
        assert PROGRAM not in names


LOADED = r"""
import sys
sys.path.insert(0, sys.argv[1])
mode = sys.argv[2]
if mode == "reference":
    import importlib.util
    spec = importlib.util.spec_from_file_location("ref", sys.argv[1] + "/nufftbench/references/nufft.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = {"shape": [8, 8], "dtype": "complex128", "m": 2, "sigma": 2.0,
           "kernel": "BackwardsKaiserBesselKernel", "kernel_evalmode": "FastApproximation"}
    import torch
    ref = mod.Reference(cfg, "cpu")
    ref.type1(torch.rand(2, 50, dtype=torch.float64), torch.ones(1, 50, dtype=torch.complex128))
else:
    from pathlib import Path
    import nufftbench.run, nufftbench.control
    from nufftbench import harness
    cell = harness.load_cell(Path(sys.argv[1]), "f64.rho0p1.fixed")
    cell.config = dict(cell.config, shape=[8, 8, 8])
    harness.run_cell(cell, 1, 0.1, mode == "traced", "cpu")
    for m in ("setup_s", "step_ms", "device_idle_pct", "spread_roofline_pct"):
        harness.metric_reader(m)
print(" ".join(sorted({n.split(".")[0] for n in sys.modules})))
"""


@pytest.mark.parametrize("mode", ["run", "traced", "reference"])
def test_loaded_modules(mode):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", LOADED, str(ROOT), mode], capture_output=True,
                         text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    loaded = set(res.stdout.split())
    assert not loaded & JAX_NAMES
    if mode == "reference":
        assert PROGRAM not in loaded
    else:
        assert PROGRAM in loaded


def test_run_refuses_forbidden_modules(monkeypatch):
    sys.path.insert(0, str(BENCH))
    try:
        import run
    finally:
        sys.path.remove(str(BENCH))
    monkeypatch.setitem(sys.modules, PROGRAM, object())
    monkeypatch.setitem(sys.modules, "nufftbench_fake", object())
    for name in list(sys.modules):
        if name.split(".")[0] in JAX_NAMES:
            monkeypatch.delitem(sys.modules, name)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "nonuniformffts_tpu.plan", object())
    assert run.forbidden_modules() == ["jax", "nonuniformffts_tpu"]


def test_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "c128.rho1.moving",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA" in res.stderr
