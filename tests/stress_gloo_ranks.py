"""Stress the gloo ranks of ``test_torch_strategies.py`` (not a test).

    PYTHONPATH=src python tests/stress_gloo_ranks.py [TRIALS] [WORLD] [BURNERS]
                                                     [SWITCH_MS]

Runs the test's ``_rank_main`` (``sync_mesh`` at k = 4, dropout 0 and
0.2, two epochs each, then the group torn down) in WORLD spawned ranks,
TRIALS times, beside BURNERS processes that keep CPU cores busy, as a
loaded test run does.  Each rank sets the interpreter's switch interval
to SWITCH_MS: a thread that waits for the interpreter lock then waits up
to that long, which widens the window in which a gloo worker thread that
must free a Python tensor is still waiting when the rank's interpreter
exits (a loaded machine opens the same window by starving the thread).
Prints each trial's outcome and the count of trials in which a rank died;
the ranks' stderr (an abort's message) goes to this process's stderr.
Defaults: 20 trials, world 4, 8 burners, 200 ms.
"""
import multiprocessing
import os
import sys
import tempfile
import time

import numpy as np


def _burn(stop_at: float) -> None:
    while time.time() < stop_at:
        pass


def _rank(rank: int, world: int, workdir: str, switch_s: float) -> None:
    import test_torch_strategies as T
    sys.setswitchinterval(switch_s)
    T._rank_main(rank, world, workdir)


def main(trials: int = 20, world: int = 4, burners: int = 8,
         switch_ms: int = 200) -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax
    import torch.multiprocessing as mp

    import test_torch_strategies as T
    from repro.models.dnn import DNNConfig, init_dnn

    init = jax.device_get(init_dnn(DNNConfig(**T.MODEL),
                                   jax.random.PRNGKey(5)))
    flat = {f"{key}{i}": layer[key] for i, layer in enumerate(init["layers"])
            for key in ("w", "b")}
    ctx_burn = multiprocessing.get_context("spawn")
    load = [ctx_burn.Process(target=_burn, args=(time.time() + 3600,),
                             daemon=True) for _ in range(burners)]
    for proc in load:
        proc.start()
    died = 0
    try:
        for trial in range(trials):
            with tempfile.TemporaryDirectory() as workdir:
                np.savez(os.path.join(workdir, "init.npz"), **flat)
                t0 = time.monotonic()
                ctx = mp.start_processes(
                    _rank, args=(world, workdir, switch_ms / 1e3),
                    nprocs=world, join=False, start_method="spawn")
                try:
                    while not ctx.join(timeout=1.0):
                        if time.monotonic() - t0 > T.JOIN_DEADLINE_S:
                            raise TimeoutError("ranks still running")
                    print(f"trial {trial}: ok, "
                          f"{time.monotonic() - t0:.1f} s", flush=True)
                except Exception as e:           # a rank died or hung
                    died += 1
                    print(f"trial {trial}: {str(e).splitlines()[0]}",
                          flush=True)
                finally:
                    for proc in ctx.processes:
                        if proc.is_alive():
                            proc.kill()
    finally:
        for proc in load:
            proc.kill()
    print(f"{died} of {trials} trials lost a rank (world {world}, "
          f"{burners} burners, switch interval {switch_ms} ms)", flush=True)
    return died


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    sys.exit(1 if main(*args) else 0)
