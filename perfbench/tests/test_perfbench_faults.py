"""``correct`` must come out false when the timed path is broken, and for
the control: each test skips the harness's look for a card and drives the
rest of a run on the CPU, at a size a test run holds, against the cell's
own limits."""
import shutil
import subprocess
import sys

import pytest

from perfbench.harness import result
from perfbench.tests.cells import ROOT, prefill_cell, run_cpu, train_cell

PREFILL = ["qwen2-1.5b.prefill_2k", "phi4-mini-3.8b.prefill_2k",
           "qwen2-1.5b.prefill_32k"]
#: The faults each prefill cell can have: a batch of one prompt has no
#: half to leave out.
FAULTS = {w: ("state_unchanged", "half_batch", "token_altered")
          for w in PREFILL[:2]}
FAULTS["qwen2-1.5b.prefill_32k"] = ("state_unchanged", "token_altered")


@pytest.mark.parametrize("workload", PREFILL)
def test_sound_run_is_correct_and_the_control_is_not(workload):
    cell = prefill_cell(workload)
    out = run_cpu(cell, control=True)
    assert result.judge(out["numbers"], cell.limits)[0], out["numbers"]
    assert not result.judge(out["control_numbers"], cell.limits)[0], \
        out["control_numbers"]


@pytest.mark.parametrize("workload, fault", [
    (w, f) for w in PREFILL for f in FAULTS[w]])
def test_a_broken_prefill_is_not_correct(workload, fault):
    cell = prefill_cell(workload)
    out = run_cpu(cell, faults=(fault,))
    assert not result.judge(out["numbers"], cell.limits)[0], out["numbers"]


def test_training_faults_read_far_above_a_sound_run():
    """The training cell (not in BENCHMARK.json until the program's fault
    is repaired, PERF.md) already tells its faults apart: each reads ten
    times a sound run or more on one of its numbers."""
    cell = train_cell({})
    sound = run_cpu(cell, control=True)
    base = sound["numbers"]
    assert base["rows_mismatch"] == 0
    for fault, number in (("state_unchanged", "delta_gap"),
                          ("half_batch", "loss_rel"),
                          ("token_altered", "rows_mismatch")):
        got = run_cpu(cell, faults=(fault,))["numbers"]
        assert got[number] > 0 and got[number] >= 10 * base[number], \
            (fault, got)
    assert sound["control_numbers"]["grad1_gap"] >= 3 * base["grad1_gap"]


def test_a_checkout_without_the_program_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "qwen2-1.5b.prefill_2k", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
