"""One short run of a cell on the card, through the benchmark's command: it
prints the contract's last line and proves correct."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_short_run_on_the_card(card, trace):
    res = subprocess.run([sys.executable, "nufftbench/run.py", "--workload", "f64.rho0p1.fixed",
                          "--seed", str(2**31 + 17), "--seconds", "2", "--trace", str(trace)],
                         capture_output=True, text=True, cwd=ROOT, timeout=1500)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert list(out)[-1] == "checks"
    assert out["correct"] and out["failed"] == 0
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    want = {"setup_s", "step_ms", "step_p95_ms", "peak_mem_gib"} if not trace else \
        {"exec_self_ms", "spread_ms", "fft_ms", "deconvolve_ms", "interp_ms",
         "spread_roofline_pct", "interp_roofline_pct"}
    assert want <= set(out["metrics"])
    for name in ("spread_roofline_pct", "interp_roofline_pct"):
        if name in out["metrics"]:
            assert 0 < out["metrics"][name]["value"] <= 100
    last = res.stderr.strip().splitlines()[-len(out["checks"]):]
    assert all(line.startswith("check ") for line in last)
