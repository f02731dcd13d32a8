"""A configuration, a traffic mix, a per-layer metric and a cell added as
new files and entries are found by name, with no file of the benchmark
edited."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

DRIVE = r"""
import json, sys
from pathlib import Path

import pytest
root = Path(sys.argv[1])
sys.path.insert(0, str(root))
from nufftbench import harness
assert Path(harness.__file__).resolve().parent == (root / "nufftbench").resolve()
cell = harness.load_cell(root, "c128_2d.rho2.fixed")
out = {"config": cell.config["shape"], "density": cell.traffic["density"],
       "per_layer": [m["name"] for m in cell.per_layer],
       "end_to_end": [m["name"] for m in cell.end_to_end]}
res = harness.run_cell(cell, 5, 0.2, True, "cpu")
out["traced"] = sorted(res["metrics"])
out["correct"] = res["correct"]
res = harness.run_cell(cell, 5, 0.2, False, "cpu")
out["untraced"] = sorted(res["metrics"])
print(json.dumps(out))
"""


def _snapshot(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted((root / "nufftbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found(tmp_path):
    shutil.copytree(ROOT / "nufftbench", tmp_path / "nufftbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _snapshot(tmp_path)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    nb = tmp_path / "nufftbench"
    cfg = json.loads((nb / "configs" / "nufft3d_256_c128.json").read_text())
    (nb / "configs" / "nufft2d_tiny_c128.json").write_text(
        json.dumps(dict(cfg, shape=[16, 20])))
    (nb / "traffic" / "rho2.fixed.json").write_text(json.dumps(
        {"density": 2.0, "motion": "fixed", "execs": ["exec_type2", "exec_type1"],
         "ntransforms": 2}))
    (nb / "metrics" / "timed_steps.py").write_text(
        "def read(rec):\n    return rec.timer_steps or None\n")
    (nb / "limits" / "c128_2d.rho2.fixed.json").write_text(
        (nb / "limits" / "c128.rho0p1.fixed.json").read_text())
    bench["configs"].append({"name": "nufft2d_tiny_c128", "source": "https://example.org",
                             "file": "nufftbench/configs/nufft2d_tiny_c128.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "c128_2d.rho2.fixed", "config": "nufft2d_tiny_c128",
                               "traffic": "rho2.fixed", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        m.get("workloads", []).append("c128_2d.rho2.fixed")
    bench["per_layer"].append({"name": "timed_steps", "unit": "1", "better": "higher",
                               "source": "program_span", "layer": "harness",
                               "moves": "step_ms", "workloads": ["c128_2d.rho2.fixed"]})
    for m in bench["per_layer"]:
        if m["name"] == "spread_ms":
            m["workloads"].append("c128_2d.rho2.fixed")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", DRIVE, str(tmp_path)], capture_output=True,
                         text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["config"] == [16, 20] and out["density"] == 2.0
    assert out["per_layer"] == ["spread_ms", "timed_steps"]
    assert out["correct"]
    assert out["traced"] == ["spread_ms", "timed_steps"]
    # peak_mem_gib reads the card's allocator: nothing to read on the CPU
    assert out["untraced"] == ["setup_s", "step_ms", "step_p95_ms"]
    # every file that was there is unchanged
    after = _snapshot(tmp_path)
    assert all(after[k] == v for k, v in before.items())


@pytest.mark.parametrize("name", [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_every_cell_is_found(name):
    """Each cell of BENCHMARK.json loads with its configuration, mix and
    limits, and every metric it reports has its reader."""
    from nufftbench import harness
    from nufftbench.traffic import Traffic

    cell = harness.load_cell(ROOT, name)
    assert set(cell.limits["limits"]) == {harness.CHECKS[n] for n in cell.traffic["execs"]}
    assert cell.per_layer and {"setup_s", "step_ms"} <= {m["name"] for m in cell.end_to_end}
    for m in cell.per_layer + cell.end_to_end:
        assert callable(harness.metric_reader(m["name"]))
    small = dict(cell.config, shape=[4, 4, 4])
    assert Traffic(small, cell.traffic, 1, "cpu").nchunks == cell.traffic.get("nchunks", 1)
