"""The port's analysis tooling (``repro_torch.analysis``): the dispatch-trace
pass (J), the CUDA launch models (V), the concurrency lint (C), the baseline
gate and the CLI.

Each pass is held to a corpus of known-bad twins it must flag and
known-good twins it must not, as the reference's ``tests/test_analysis.py``
does for its passes; where the reference's own tests pass on the CPU, the
port is held to the reference too (the AST pass's fingerprints, the
baseline format, the entries' (B, B) counts).  Everything runs on the CPU
(``--device cpu``): the kernel wrappers run their plain versions inside
their kernel boundaries.
"""
from __future__ import annotations

import dataclasses
import json
import os
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import (  # noqa: E402
    RULES,
    AuditReport,
    EntryPoint,
    Finding,
    audit_entry,
    audit_file,
    audit_paths,
    count_bxb_intermediates,
    load_baseline,
    save_baseline,
    unbaselined,
)
from repro_torch.analysis import cli, entrypoints  # noqa: E402
from repro_torch.analysis import graph_audit as ga  # noqa: E402
from repro_torch.analysis import launch_audit as la  # noqa: E402
from repro_torch.analysis.concurrency_audit import (  # noqa: E402
    DEFAULT_TARGETS, THREADED_MODULES)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rules(findings):
    return sorted(f.rule for f in findings)


@pytest.fixture(autouse=True)
def _entries_on_the_cpu():
    entrypoints.set_device("cpu")


@pytest.fixture(scope="module")
def ci_run(tmp_path_factory):
    """One ``--ci --device cpu`` run of every pass over the tree against
    the committed baseline: (exit code, report, seconds)."""
    import time
    entrypoints.set_device("cpu")
    report = str(tmp_path_factory.mktemp("audit") / "report.json")
    cwd = os.getcwd()
    os.chdir(REPO_ROOT)
    try:
        t0 = time.perf_counter()
        rc = cli.main(["--ci", "--device", "cpu", "--report", report])
        seconds = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    with open(report) as fh:
        return rc, json.load(fh), seconds


# ============================================================ J (traces)
class TestGraphAudit:
    B = 64

    def _logp_W(self):
        rng = np.random.default_rng(0)
        logp = torch.log_softmax(torch.tensor(
            rng.standard_normal((self.B, 39)), dtype=torch.float32), -1)
        return logp, torch.ones(self.B, self.B)

    def test_bad_dense_bxb_flagged(self):
        logp, W = self._logp_W()

        def f(logp, W):
            p = torch.exp(logp)
            return -torch.sum(W * (p @ logp.T))     # dense B×B product

        findings, metrics = audit_entry(EntryPoint(
            "bad", lambda: (f, (logp, W)), B=self.B, expect_bxb=0))
        assert "J002" in _rules(findings)
        assert metrics["bxb_outside_kernels"] >= 1

    def test_good_fused_twin_clean(self):
        from repro_torch.kernels.ops import graph_regularizer_fused

        logp, W = self._logp_W()

        def f(logp, W):
            lp, w = logp.requires_grad_(True), W.requires_grad_(True)
            loss = graph_regularizer_fused(lp, w, 0.5, 1e-3)
            return torch.autograd.grad(loss, (lp, w))

        findings, metrics = audit_entry(EntryPoint(
            "good", lambda: (f, (logp, W)), B=self.B, expect_bxb=0))
        assert findings == []
        assert metrics["bxb_outside_kernels"] == 0
        assert metrics["kernel_ops"] > 0

    def test_bxb_just_outside_a_kernel_call_flagged(self):
        """A boundary must not hide a product made right before the kernel:
        W ⊙ W outside, then the fused kernel."""
        from repro_torch.kernels.ops import graph_regularizer_fused

        logp, W = self._logp_W()
        findings, metrics = audit_entry(EntryPoint(
            "planted", lambda: ((lambda lp, w: graph_regularizer_fused(
                lp, w * w, 0.5, 1e-3)), (logp, W)), B=self.B))
        assert _rules(findings) == ["J002"]
        assert metrics["bxb_outside_kernels"] == 1

    def test_canary_guards_the_counter(self):
        logp, W = self._logp_W()
        findings, _ = audit_entry(EntryPoint(
            "canary", lambda: ((lambda lp, w: lp.sum()), (logp, W)),
            B=self.B, expect_bxb=None, canary_min_bxb=3))
        assert _rules(findings) == ["J000"]

    def test_count_bxb_intermediates(self):
        from repro_torch.kernels import ref
        from repro_torch.kernels.ops import graph_regularizer_fused

        logp, W = self._logp_W()
        assert count_bxb_intermediates(
            lambda lp, w: graph_regularizer_fused(lp, w, 0.5, 1e-3),
            logp, W, B=self.B) == 0
        assert count_bxb_intermediates(
            lambda lp, w: ref.graph_regularizer_ref(lp, w, 0.5, 1e-3),
            logp, W, B=self.B) >= 2             # the forward alone

    def test_bf16_promotion_flagged_and_twin_clean(self):
        x = torch.zeros(64, 64, dtype=torch.bfloat16)
        bad, _ = audit_entry(EntryPoint(
            "promo", lambda: ((lambda x: x.float() @ x.float().T), (x,)),
            compute_dtype="bfloat16"))
        assert "J003" in _rules(bad)
        assert any(f.detail == "bfloat16->float32" for f in bad)
        good, _ = audit_entry(EntryPoint(
            "promo_ok", lambda: ((lambda x: x * 2), (x,)),
            compute_dtype="bfloat16"))
        assert good == []

    def test_f64_leak_flagged_and_twin_clean(self):
        x = torch.zeros(8, 8)
        bad, _ = audit_entry(EntryPoint(
            "leak", lambda: ((lambda x: x.double() * 2.0), (x,))))
        assert _rules(bad) == ["J003"]
        good, _ = audit_entry(EntryPoint(
            "no_leak", lambda: ((lambda x: x * 2.0), (x,))))
        assert good == []

    def _chunked(self, sync_at: str):
        def fn(x):
            for i in range(2):
                with ga.step(i):
                    x = x * 2
                    if sync_at == "step":
                        float(x.sum())
                    elif sync_at == "tolist":
                        x.sum().tolist()
                if sync_at == "between" and i == 0:
                    bool((x > 0).all())
            if sync_at == "after":
                float(x.sum())      # the chunk has ended
            return x
        fn.chunk_steps = 2
        return EntryPoint(f"sync_{sync_at}", lambda: (fn, (torch.ones(4),)))

    @pytest.mark.parametrize("where,detail,count", [
        ("step", "_local_scalar_dense", 2), ("tolist", "tolist", 2),
        ("between", "_local_scalar_dense", 1)])
    def test_sync_inside_a_chunk_flagged(self, where, detail, count):
        findings, metrics = audit_entry(self._chunked(where))
        assert _rules(findings) == ["J004"]
        assert findings[0].detail == detail
        assert metrics["host_syncs_in_chunk"] == count

    def test_sync_after_the_chunk_clean(self):
        findings, metrics = audit_entry(self._chunked("after"))
        assert findings == []
        assert metrics["host_syncs_in_chunk"] == 0

    @pytest.mark.parametrize("sync", [True, False])
    def test_sync_inside_a_kernel_boundary_flagged(self, sync):
        """A wrapper is Python code: a fetch inside its boundary (either
        branch) is a host sync in the chunk all the same; the wrapper
        without it is clean."""
        from repro_torch.kernels.boundary import bounded

        @bounded("graph_reg_fwd")
        def wrapper(x):
            if sync:
                x.sum().item()
            return x * 2

        def fn(x):
            for i in range(2):
                with ga.step(i):
                    x = wrapper(x)
            return x
        fn.chunk_steps = 2
        findings, metrics = audit_entry(EntryPoint(
            "wrapper_sync", lambda: (fn, (torch.ones(4),))))
        if sync:
            assert _rules(findings) == ["J004"]
            assert findings[0].detail == "_local_scalar_dense@graph_reg_fwd"
            assert metrics["host_syncs_in_chunk"] == 2
        else:
            assert findings == [] and metrics["host_syncs_in_chunk"] == 0

    def test_sync_check_spans_each_chunk(self, monkeypatch):
        """``sync_check`` turns the card's sync debug mode on at a chunk's
        first step and off after its last, and off for the recorder's own
        read of scatter indices."""
        modes = []
        monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)

        def fn(x):
            for i in range(4):
                with ga.step(i):
                    modes.append(f"step {i}")
                    x = x.index_add(0, torch.tensor([0, 0]), torch.ones(2))
            return x
        fn.chunk_steps = 2
        ga.trace_entry(EntryPoint("chunks", lambda: (fn, (torch.zeros(4),))),
                       sync_check=True)
        assert modes == ["error", "step 0", 0, "error", "step 1", 0, "error",
                         0, "error", "step 2", 0, "error", "step 3", 0,
                         "error", 0]

    def test_trace_keeps_the_entry_launches(self, monkeypatch):
        """A trace records the launches each wrapper counted during the
        run (none on the CPU, where the plain versions run)."""
        from repro_torch.kernels import graph_reg
        trace = ga.trace_entry(entrypoints.graph_reg_fused)
        assert trace.launches == {}

        def launching(x):
            graph_reg.reg_forward.launches += 1
            return x * 2
        trace = ga.trace_entry(EntryPoint(
            "launching", lambda: (launching, (torch.ones(4),))))
        assert trace.launches == {"graph_reg_fwd": 1}

    def _carry_entry(self, body):
        def fn(carry):
            with ga.step(0):
                body(carry)
            return carry
        fn.chunk_steps = 1
        return EntryPoint("carry", lambda: (fn, ({"w": torch.zeros(4)},)),
                          donate=0)

    def test_replaced_carry_flagged_and_in_place_twin_clean(self):
        def replace(c):
            c["w"] = c["w"] + 1

        bad, metrics = audit_entry(self._carry_entry(replace))
        assert _rules(bad) == ["J005"] and bad[0].detail == "w:storage"
        assert metrics["carry_in_place"] is False
        good, metrics = audit_entry(self._carry_entry(
            lambda c: c["w"].add_(1)))
        assert good == [] and metrics["carry_in_place"] is True

    def test_full_size_carry_copy_in_a_chunk_flagged(self):
        def copy(c):
            c["backup"] = c["w"].clone()
            c["w"].add_(1)

        findings, _ = audit_entry(self._carry_entry(copy))
        assert _rules(findings) == ["J005"]
        assert findings[0].detail == "w:copy"

    def test_captured_constant_flagged_and_argument_twin_clean(self):
        big = torch.ones(512, 1024)            # 2 MiB
        bad, metrics = audit_entry(EntryPoint(
            "captured", lambda: ((lambda x: x + big.sum()),
                                 (torch.ones(4),))))
        assert _rules(bad) == ["J006"]
        assert metrics["captured_const_bytes"] == big.numel() * 4
        good, _ = audit_entry(EntryPoint(
            "passed", lambda: ((lambda x, b: x + b.sum()),
                               (torch.ones(4), big))))
        assert good == []

    def test_engine_steps_marked_through_step_scope(self):
        """The engine entries mark their steps through ``Engine.step_scope``
        (its default opens nothing)."""
        from repro_torch.train.engine import Engine
        fn, _ = entrypoints._build_engine("sequential")
        assert fn.engine.step_scope is ga.step
        with Engine.step_scope(0) as scope:
            assert scope is None

    def test_guard_fetch_falls_between_chunks(self):
        """The engine's guard fetches once a window, after the window's
        last step: outside the chunk, so not a J004 finding."""
        trace = ga.trace_entry(entrypoints.engine_sequential)
        fetches = [op for op in trace.ops if op.packet == "tolist"]
        assert fetches and not any(op.in_chunk for op in fetches)
        assert {op.step for op in trace.ops if op.step is not None} == \
            set(range(entrypoints.CHUNK_STEPS))

    def test_guard_replay_fetches_outside_the_chunk(self):
        """A tainted window is replayed after the chunk, one fetch a
        replayed step (engine.py's ``.item()``): still no J004."""
        fn, args = entrypoints._build_engine("sequential")
        carry, batches, lr = args
        batches[1][1]["x"][0, 0, 0] = float("nan")
        findings, _ = audit_entry(EntryPoint(
            "tainted", lambda: (fn, args), donate=0))
        trace = ga.trace_entry(EntryPoint("tainted", lambda: (fn, args)))
        items = [op for op in trace.ops
                 if op.packet == "_local_scalar_dense"]
        assert len(items) == entrypoints.CHUNK_STEPS
        assert not any(op.in_chunk for op in items)
        assert "J004" not in _rules(findings)

    def test_registered_entries_hold_their_contracts(self, ci_run):
        rc, data, _ = ci_run
        entries = data["metrics"]["jaxpr/entries"]
        for name in ("graph_reg_fused", "graph_reg_blocksparse", "knn_topk",
                     "online_refresh", "ssl_objective"):
            assert entries[name]["bxb_outside_kernels"] == 0, name
            assert entries[name]["kernel_ops"] > 0, name
        assert entries["graph_reg_ref"]["bxb_outside_kernels"] >= 3
        assert entries["graph_reg_ref"]["kernel_ops"] == 0
        for name in ("engine_sequential", "engine_sync_mesh",
                     "engine_async_ps", "engine_capture"):
            assert entries[name]["carry_in_place"] is True, name
            assert entries[name]["host_syncs_in_chunk"] == 0, name
        assert data["new_findings"] == [] and rc == 0


def test_bxb_counts_match_the_reference():
    """The fused entry counts 0 (B, B) outputs outside its kernels in both
    packages, and both canaries count at least 3."""
    pytest.importorskip("jax")
    from repro.analysis import audit_entry as ref_audit
    from repro.analysis import entrypoints as ref_entries

    for name, check in (("graph_reg_fused", lambda n: n == 0),
                        ("graph_reg_ref", lambda n: n >= 3)):
        _, ref_m = ref_audit(getattr(ref_entries, name))
        _, port_m = audit_entry(getattr(entrypoints, name))
        assert check(ref_m["bxb_outside_kernels"]), name
        assert check(port_m["bxb_outside_kernels"]), name


# ======================================================= V (launch models)
def _launch(**over):
    base = la.Launch(
        "k", "v", "x.cu", "1kE", (4, 1, 1), 256, 1024, 0, (256, 0),
        outputs=(la.Output("out", (4, 8), lambda x, y, z: [
            ((x, x + 1), (0, 8))]),))
    return dataclasses.replace(base, **over)


class TestLaunchAudit:
    def test_default_models_validate_clean(self):
        findings, metrics = la.validate_launches()
        assert findings == []
        assert metrics["kernels_in_source"] == 21
        assert metrics["kernels_modelled"] == 21
        assert metrics["launches_checked"] >= 40

    def test_every_kernel_models_its_path_shapes(self):
        kernels = {ln.kernel for _, ln in la.kernel_launches()}
        assert kernels == set(la.source_kernels())
        variants = {ln.variant for _, ln in la.kernel_launches()
                    if ln.kernel == "knn_topk_kernel"}
        assert {f"N=20000 M=20000 D=351 k={k}" for k in (10, 40, 300, 1000)
                } <= variants
        symbols = {ln.symbol for _, ln in la.kernel_launches()}
        assert {"15knn_topk_kernelILb0ELb1E", "15knn_topk_kernelILb0ELb0E",
                "15knn_topk_kernelILb1ELb0E", "19rbf_affinity_kernelILi64E",
                "19rbf_affinity_kernelILi128E"} <= symbols
        # K14 at the four prefill cells' rows, every config's width in
        # both dtypes: every instantiation of its occupancy table.
        from repro_torch.kernels import norm
        assert set(norm.OCCUPANCY_KERNELS) <= symbols
        assert {"bfloat16 rows=8192 d=1536", "bfloat16 rows=32768 d=1536",
                "bfloat16 rows=8192 d=3072", "bfloat16 rows=8192 d=4096"
                } <= {ln.variant for _, ln in la.kernel_launches()
                      if ln.kernel == "rms_norm_kernel"}

    def test_one_byte_over_the_budget_flagged_and_twin_clean(self):
        at = _launch(dynamic_smem=la.SMEM_BLOCK_BYTES)
        assert la.check_launch(at, where="t") == []
        over = _launch(dynamic_smem=la.SMEM_BLOCK_BYTES + 1)
        assert _rules(la.check_launch(over, where="t")) == ["V001"]

    def test_launch_bounds_minimum_must_fit(self):
        bad = _launch(dynamic_smem=80 * 1024, launch_bounds=(256, 3))
        assert _rules(la.check_launch(bad, where="t")) == ["V001"]
        good = _launch(dynamic_smem=60 * 1024, launch_bounds=(256, 3))
        assert la.check_launch(good, where="t") == []
        many = _launch(threads=512, launch_bounds=(256, 0))
        assert _rules(la.check_launch(many, where="t")) == ["V001"]

    def test_resident_blocks_below_the_launch_bounds_flagged(self):
        """On the card the runtime's resident blocks (registers included)
        are held to the launch bounds' minimum."""
        ln = _launch(static_smem=41216, dynamic_smem=0,
                     launch_bounds=(256, 3))
        assert la.check_launch(ln, where="t", resident=3) == []
        findings = la.check_launch(ln, where="t", resident=2)
        assert _rules(findings) == ["V001"]
        assert findings[0].detail == "resident"

    def test_every_model_is_in_its_librarys_occupancy_table(self):
        """The card reads each model's resident blocks from its library's
        occupancy table, by the model's symbol."""
        from repro_torch.kernels import (flash_attention, graph_reg,
                                         graph_reg_bsp, moe, norm, pairwise)
        modules = {m.__name__.rsplit(".", 1)[1]: m for m in
                   (graph_reg, graph_reg_bsp, pairwise, flash_attention, moe,
                    norm)}
        for where, ln in la.kernel_launches():
            table = modules[la._LIBRARY[ln.source]].OCCUPANCY_KERNELS
            assert ln.symbol in table, where

    def test_misaligned_vector_and_tma_box_flagged(self):
        bad = _launch(vectors=(la.Vector("logP rows", 4 * 39),))
        assert _rules(la.check_launch(bad, where="t")) == ["V002"]
        good = _launch(vectors=(la.Vector("padded logP rows", 4 * 40),))
        assert la.check_launch(good, where="t") == []
        box = _launch(vectors=(la.Vector("q rows", 256, box_inner_bytes=96),))
        assert _rules(la.check_launch(box, where="t")) == ["V002"]
        ok = _launch(vectors=(la.Vector("q rows", 256, box_inner_bytes=128),))
        assert la.check_launch(ok, where="t") == []

    def test_grid_must_cover_the_output_exactly(self):
        gap = _launch(grid=(3, 1, 1))
        assert [f.detail for f in la.check_launch(gap, where="t")] == \
            ["out:uncovered"]
        past = _launch(grid=(5, 1, 1))
        assert "out:past" in [f.detail for f in
                              la.check_launch(past, where="t")]
        cluster = _launch(cluster=(3, 1, 1))
        assert [f.detail for f in la.check_launch(cluster, where="t")] == \
            ["cluster"]

    def test_unmodelled_kernel_flagged(self, tmp_path):
        for path in la.CSRC.iterdir():
            (tmp_path / path.name).write_text(path.read_text())
        (tmp_path / "extra.cu").write_text(
            "__global__ void __launch_bounds__(128) stray(float* x) {}\n")
        findings, metrics = la.validate_launches(csrc=tmp_path)
        assert _rules(findings) == ["V005"]
        assert metrics["kernels_in_source"] == 22

    def test_launch_bounds_held_to_the_source(self):
        (where, ln), *rest = la.kernel_launches()
        wrong = dataclasses.replace(ln, launch_bounds=(512, 0))
        findings, _ = la.validate_launches(
            [(where, wrong)] + [r for r in rest if r[1].kernel != ln.kernel])
        assert [f.detail for f in findings] == [f"{ln.kernel}:bounds"]

    def test_plan_mirrors_at_the_paths_shape(self):
        """K1's and K2's Python mirrors give the source's plans at P =
        2176 on 132 SMs: 20 rows (109 blocks) and 36-row clusters (61);
        at the smoke's SSL head (1, 4, 512) K1 takes the class-split plan:
        4 chunks of 128 classes, one 256-thread block each, and one
        block of pass 2."""
        from repro_torch.kernels import graph_reg
        fwd = graph_reg.fwd_plan(1, 2176, 39, n_sm=132)
        dl = graph_reg.dlogp_plan(1, 2176, 39, n_sm=132)
        assert fwd["rows_per_block"] == 20
        assert dl["rows_per_block"] == 36
        (k1,) = [ln for ln in la.call_launches("graph_reg_fwd", k=1, B=2176,
                                               C=39)
                 if ln.kernel == "reg_fwd_partials"]
        (k2,) = [ln for ln in la.call_launches("graph_reg_bwd_dlogp", k=1,
                                               B=2176, C=39)
                 if ln.kernel == "reg_bwd_dlogp"]
        assert k1.grid == (109, 1, 1) and k2.grid == (122, 1, 1)
        smoke = graph_reg.fwd_plan(1, 4, 512, n_sm=132)
        assert (smoke["route"], smoke["class_chunk"],
                smoke["dynamic_smem_bytes"]) == ("classes", 128, 12672)
        part, total = la.call_launches("graph_reg_fwd", k=1, B=4, C=512)
        assert (part.kernel, part.grid, part.threads) == (
            "reg_fwd_class_partials", (4, 1, 1), 256)
        assert (total.kernel, total.grid) == ("reg_fwd_class_sum",
                                              (1, 1, 1))

    @pytest.mark.parametrize("shape,grid,threads,smem", [
        ((1, 16, 151936), (264, 1, 1), 256, 100416),
        ((2, 16, 151936), (132, 1, 2), 256, 100416),
        ((1, 17, 32000), (250, 1, 1), 160, 55024),
        ((1, 4, 512), (4, 1, 1), 32, 12432)])
    def test_k2_class_route_at_the_lm_heads(self, shape, grid, threads,
                                            smem):
        """At the LM heads K2 is one launch of ``reg_bwd_dlogp_classes``
        (no ``pad_classes``, no cluster): a block per class span and
        worker, two an SM on 132 SMs, 4-row groups of whole warps, 4
        classes a thread, all B rows; the model covers dlogp once and
        stays in budget."""
        k, B, C = shape
        (ln,) = la.call_launches("graph_reg_bwd_dlogp", k=k, B=B, C=C)
        assert (ln.kernel, ln.grid, ln.threads, ln.dynamic_smem,
                ln.cluster) == ("reg_bwd_dlogp_classes", grid, threads, smem,
                                (1, 1, 1))
        assert la.check_launch(ln, where="t") == []
        cov = la.coverage(ln)["dlogp"]
        assert cov == {"past": [], "overlap": None, "uncovered": 0}

    def test_v004_is_not_applicable(self):
        assert "not applicable" in RULES["V004"]
        findings, _ = la.validate_launches()
        assert "V004" not in _rules(findings)


# ================================================== C (concurrency lint)
def _lint(tmp_path, source):
    path = tmp_path / "snippet.py"
    path.write_text(textwrap.dedent(source))
    findings, _ = audit_file(str(path), where="snippet")
    return findings


SNIPPETS = {
    "unlocked": """
        import threading
        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0
            def bump(self):
                with self._lock:
                    self.count += 1
            def peek(self):
                return self.count
    """,
    "locked": """
        import threading
        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0
            def bump(self):
                with self._lock:
                    self.count += 1
            def peek(self):
                with self._lock:
                    return self.count
    """,
    "nested": """
        import threading
        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self.state = 0
            def read(self):
                with self._lock:
                    return self.state
            def sneaky(self):
                with self._lock:
                    def later():
                        self.state += 1
                    return later
    """,
    "unjoined": """
        import threading
        def go():
            t = threading.Thread(target=print)
            t.start()
    """,
    "joined": """
        import threading
        def go():
            t = threading.Thread(target=print)
            t.start()
            t.join()
    """,
    "published": """
        import threading
        def go():
            box = {}
            def work():
                box["x"] = 1
            t = threading.Thread(target=work, daemon=True)
            t.start()
            return box["x"]
    """,
    "published_joined": """
        import threading
        def go():
            box = {}
            def work():
                box["x"] = 1
            t = threading.Thread(target=work, daemon=True)
            t.start()
            t.join()
            return box["x"]
    """,
}
EXPECTED = {"unlocked": ["C001"], "locked": [], "nested": ["C001"],
            "unjoined": ["C002"], "joined": [], "published": ["C003"],
            "published_joined": []}


class TestConcurrencyAudit:
    @pytest.mark.parametrize("name", sorted(SNIPPETS))
    def test_twins(self, tmp_path, name):
        assert _rules(_lint(tmp_path, SNIPPETS[name])) == EXPECTED[name]

    def test_details_name_the_site(self, tmp_path):
        assert _lint(tmp_path, SNIPPETS["unlocked"])[0].detail == \
            "count@peek"
        assert _lint(tmp_path, SNIPPETS["nested"])[0].detail == \
            "state@sneaky"

    def test_suppression_marker_waives_named_rule_only(self, tmp_path):
        src = SNIPPETS["unlocked"].replace(
            "return self.count", "return self.count  # audit: safe({rule})"
            ": stats only")
        assert _lint(tmp_path, src.format(rule="C001")) == []
        assert _rules(_lint(tmp_path, src.format(rule="C002"))) == ["C001"]

    def test_repo_threaded_modules_are_clean(self):
        findings, metrics = audit_paths(DEFAULT_TARGETS, root=REPO_ROOT)
        assert findings == [], [f.format() for f in findings]
        stream = metrics["files"]["src/repro_torch/data/pipeline.py"]
        guarded = stream["classes"]["MetaBatchStream"]["guarded"]
        assert {"plan", "_pending", "_plan_epoch", "_failed"} <= set(guarded)
        assert sum(m["threads_seen"] for m in metrics["files"].values()) == 2

    def test_every_threaded_port_module_is_registered(self):
        """A module that starts a thread or takes a lock is linted."""
        root = os.path.join(REPO_ROOT, "src", "repro_torch")
        threaded = set()
        for dirpath, _, files in os.walk(root):
            for name in files:
                path = os.path.join(dirpath, name)
                if not name.endswith(".py") or "analysis" in dirpath:
                    continue
                text = open(path).read()
                if "threading.Thread(" in text or "threading.Lock(" in text:
                    threaded.add(os.path.relpath(path, REPO_ROOT))
        assert threaded <= set(THREADED_MODULES.values())
        assert {"src/repro_torch/train/engine.py",
                "src/repro_torch/online/refresh.py"} <= set(
                    THREADED_MODULES.values())

    @pytest.mark.parametrize("name", sorted(SNIPPETS))
    def test_fingerprints_match_the_reference(self, tmp_path, name):
        """The same fixture source gives the same fingerprints through
        both packages' C001-C003."""
        from repro.analysis.concurrency_audit import audit_file as ref_file
        path = tmp_path / "snippet.py"
        path.write_text(textwrap.dedent(SNIPPETS[name]))
        port, _ = audit_file(str(path), where="snippet")
        ref, _ = ref_file(str(path), where="snippet")
        assert [f.fingerprint for f in port] == \
            [f.fingerprint for f in ref]
        assert [(f.line, f.message) for f in port] == \
            [(f.line, f.message) for f in ref]


# ================================================ findings / baseline gate
class TestBaselineGate:
    def test_fingerprint_is_stable_across_lines(self):
        a = Finding("vmem", "V001", "pad_classes/x", "msg", line=10)
        b = Finding("vmem", "V001", "pad_classes/x", "other msg", line=99)
        assert a.fingerprint == b.fingerprint

    def test_baseline_roundtrip_and_gate(self, tmp_path):
        path = str(tmp_path / "baseline.json")
        known = Finding("jaxpr", "J002", "x", "known")
        fresh = Finding("jaxpr", "J002", "y", "fresh")
        save_baseline(path, [known])
        baseline = load_baseline(path)
        assert unbaselined([known, fresh], baseline) == [fresh]
        assert load_baseline(str(tmp_path / "missing.json")) == set()

    def test_info_findings_do_not_gate(self):
        report = AuditReport()
        report.extend("vmem", [Finding("vmem", "V001", "x", "m",
                                       severity="info")])
        assert report.gating == []

    def test_report_serializes_new_findings(self, tmp_path):
        report = AuditReport()
        f = Finding("vmem", "V001", "x", "m")
        report.extend("vmem", [f], {"launches_checked": 1})
        path = str(tmp_path / "report.json")
        report.write(path, baseline=set())
        data = json.loads(open(path).read())
        assert data["new_findings"] == [f.fingerprint]
        assert data["metrics"]["vmem/launches_checked"] == 1
        assert data["findings"][0]["rule_doc"] == RULES["V001"]

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_baseline_files_are_read_by_both_packages(self, tmp_path,
                                                      writer):
        from repro.analysis import findings as ref
        path = str(tmp_path / "baseline.json")
        args = ("jaxpr", "J002", "graph_reg_fused", "m")
        if writer == "port":
            save_baseline(path, [Finding(*args, detail="bxb>0")])
            got = ref.load_baseline(path)
        else:
            ref.save_baseline(path, [ref.Finding(*args, detail="bxb>0")])
            got = load_baseline(path)
        assert got == {"jaxpr:J002:graph_reg_fused:bxb>0"}

    def test_every_reference_rule_id_is_kept(self):
        from repro.analysis.findings import RULES as REF_RULES
        assert set(RULES) == set(REF_RULES)

    def test_committed_baseline_is_the_ports_own(self):
        path = os.path.join(REPO_ROOT, cli.BASELINE)
        assert os.path.exists(path)
        assert load_baseline(path) == set()
        with open(os.path.join(REPO_ROOT, "pyproject.toml")) as fh:
            assert "analysis/AUDIT_baseline.json" in fh.read()


# ------------------------------------------------------------------- CLI
def test_cli_ci_run_on_the_tree(ci_run):
    rc, data, seconds = ci_run
    assert rc == 0
    assert set(data["passes"]) == set(cli.PASSES) | {"waivers"}
    assert data["passes"]["waivers"]["waivers_stale"] == 0
    assert data["passes"]["waivers"]["waivers_used"] == \
        data["passes"]["waivers"]["waivers_seen"] >= 3
    assert data["new_findings"] == []
    assert seconds < 60


def test_cli_clean_run_exits_zero(tmp_path):
    report = str(tmp_path / "report.json")
    baseline = str(tmp_path / "baseline.json")
    assert cli.main(["--passes", "vmem,concurrency", "--device", "cpu",
                     "--report", report, "--baseline", baseline]) == 0
    data = json.loads(open(report).read())
    assert data["passes"]["vmem"]["findings"] == 0


def test_cli_gates_on_unbaselined_findings(tmp_path, monkeypatch):
    bad_finding = Finding("vmem", "V001", "corpus", "too big")

    def fake_vmem(report, *_):
        report.extend("vmem", [bad_finding], {"launches_checked": 1})

    monkeypatch.setattr(cli, "_run_vmem", fake_vmem)
    args = ["--passes", "vmem", "--device", "cpu",
            "--report", str(tmp_path / "report.json"),
            "--baseline", str(tmp_path / "baseline.json")]
    assert cli.main(args) == 1                      # new finding -> fail
    assert cli.main(args + ["--update-baseline"]) == 0
    assert cli.main(args) == 0                      # accepted -> pass


def test_cli_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--only", "concurrency",
                  "--report", str(tmp_path / "r.json")])
