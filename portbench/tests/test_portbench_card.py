"""The benchmark's command end to end on the card: a short run of each
cell prints a correct result line (skipped where there is no card)."""

import json
import subprocess
import sys

import pytest

from portbench import spec


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["atm-e4", "hurricane-e4", "atm-psnr60"])
def test_command_runs_a_cell_on_the_card(cuda_device, cell):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(2**31 + 3),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=360, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"compress_GBps", "ratio", "setup_s"}
    assert list(res)[-1] == "checks"
