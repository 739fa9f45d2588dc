"""The card smoke: one cell run by the benchmark's own command on the
card (skipped without one: `python -m pytest portbench/tests -m card` on
the chip)."""
import json
import subprocess
import sys

import pytest

from portbench import catalog


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark runs only there")


@pytest.mark.card
def test_one_cell_runs_correct_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, str(catalog.HERE / "run.py"), "--workload",
         "qwen2-0.5b-sampled50", "--seed", "2147483747", "--seconds", "3",
         "--trace", "0"], cwd=catalog.ROOT, capture_output=True, text=True,
        timeout=1200)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    cell = catalog.find_cell(catalog.load_benchmark(),
                             "qwen2-0.5b-sampled50")
    assert {m["name"] for m in cell.end_to_end} == set(res["metrics"])
