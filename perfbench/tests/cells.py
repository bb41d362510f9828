"""Cells cut to a size the CPU runs in seconds: every width shrunk, the
dtype and the traffic's shape kept."""
import copy
import json
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=512)
#: The prefill mixes' lengths at CPU size.
PREFILL = {"prefill_2k": dict(prompt_len=64, min_request_s=0.05),
           "prefill_32k": dict(prompt_len=256, min_request_s=0.05)}


def tiny(cell, **traffic):
    """``cell`` at CPU size: the configuration's widths cut to TINY, the
    traffic's lengths as given."""
    cell = copy.deepcopy(cell)
    cell.config.update(TINY)
    cell.traffic.update(traffic)
    return cell


def prefill_cell(workload):
    """A prefill cell of BENCHMARK.json, with its limits, at CPU size."""
    from perfbench.harness import spec
    cell = spec.load_cell(workload, ROOT)
    return tiny(cell, **PREFILL[workload.rsplit(".", 1)[1]])


def train_cell(limits):
    """The training cell's files (``train_4k`` on qwen2-1.5b) at CPU size;
    its limits are the caller's, since the cell is not in BENCHMARK.json
    (PERF.md, Open questions)."""
    from perfbench.harness import spec
    cell = spec.Cell(
        name="qwen2-1.5b.train_4k", chips=1,
        config=json.loads((BENCH / "configs" / "qwen2-1.5b.json").read_text()),
        traffic=json.loads((BENCH / "traffic" / "train_4k.json").read_text()),
        limits=limits, end_to_end=[], per_layer=[])
    return tiny(cell, seq_len=64, n_seqs=64, meta_batch=4)


def run_cpu(cell, *, seed=3, seconds=0.5, trace=False, **kw):
    """One run of ``cell`` on the CPU, past the harness's look for a card."""
    import torch

    from perfbench import run
    return run.run_cell(cell, seed=seed, seconds=seconds, trace=trace,
                        device=torch.device("cpu"),
                        t_process=time.perf_counter(), strict=False, **kw)
