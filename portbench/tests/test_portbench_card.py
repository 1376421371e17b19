"""Each cell run by the benchmark's command on the card: a short window, the
result line, correct.  Marked gpu; skips where torch sees no CUDA card."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT
from portbench.harness import manifest

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(cell, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483651", "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], proc.stderr[-2000:]
    assert result["device"]["platform"] == "gpu"
    names = {m["name"] for m in (manifest.cell(cell).per_layer if trace
                                 else manifest.cell(cell).end_to_end)}
    assert set(result["metrics"]) == names
    assert list(result)[-1] == "checks"
    assert proc.stderr.rstrip().splitlines()[-1].startswith("check ")
