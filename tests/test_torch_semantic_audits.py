"""The port's semantic audit tier: the R (generator states), W (write
races and tile lists), D (determinism) and S (collectives) passes, the
waivers, and the CLI's pass subsets.

Every rule is exercised as a twin — a known-bad fixture the pass must flag
and a known-good twin it must not — as the reference's
``tests/test_semantic_audits.py`` does.  The R-pass twins include the
prefill-sampling canary: drawing during prefill and dropping the sample.
Where the reference's passes run on the CPU (the host D002/D003 sweep, the
waiver scanner) the port is held to them on the same fixtures.
"""
from __future__ import annotations

import os
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import (  # noqa: E402
    EntryPoint,
    Finding,
    analyze_rng,
    apply_waivers,
    audit_entry_determinism,
    audit_entry_rng,
    audit_entry_sharding,
    audit_races,
    audit_seeded_modules,
    check_launch_races,
    check_layout,
    check_tile_list,
    scan_waivers,
    stale_waiver_findings,
)
from repro_torch.analysis import cli, entrypoints  # noqa: E402
from repro_torch.analysis import graph_audit as ga  # noqa: E402
from repro_torch.analysis import launch_audit as la  # noqa: E402
from repro_torch.core.metabatch import layout_from_occupancy  # noqa: E402

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rules(findings):
    return sorted(f.rule for f in findings)


def _rng(fn, *args, chunk_steps: int = 0):
    fn.chunk_steps = chunk_steps
    trace = ga.trace_entry(EntryPoint("fixture", lambda: (fn, args)))
    return analyze_rng(trace, where="fixture")


@pytest.fixture(autouse=True)
def _entries_on_the_cpu():
    entrypoints.set_device("cpu")


# ============================================================ R-pass (rng)
class TestRngAudit:
    def test_r001_two_generators_one_seed_flagged(self):
        def bad():
            a = torch.rand(4, generator=torch.Generator().manual_seed(0))
            b = torch.rand(4, generator=torch.Generator().manual_seed(0))
            return a + b
        findings, metrics = _rng(bad)
        assert _rules(findings) == ["R001"]
        assert metrics["draws"] == 2 and metrics["states"] == 1

    def test_r001_one_advancing_generator_clean(self):
        def good():
            g = torch.Generator().manual_seed(0)
            return torch.rand(4, generator=g) + torch.rand(4, generator=g)
        findings, metrics = _rng(good)
        assert findings == []
        assert metrics["states"] == 2

    def test_r002_reseeded_each_step_flagged(self):
        def bad(x):
            g = torch.Generator()
            for i in range(2):
                with ga.step(i):
                    g.manual_seed(0)
                    x = x + torch.rand(4, generator=g)
            return x
        findings, _ = _rng(bad, torch.zeros(4), chunk_steps=2)
        assert _rules(findings) == ["R002"]

    def test_r002_advancing_across_steps_clean(self):
        def good(x):
            g = torch.Generator().manual_seed(0)
            for i in range(2):
                with ga.step(i):
                    x = x + torch.rand(4, generator=g)
            return x
        findings, _ = _rng(good, torch.zeros(4), chunk_steps=2)
        assert findings == []

    def test_r003_dead_draw_flagged_and_used_twin_clean(self):
        def bad(x):
            torch.rand(4, generator=torch.Generator().manual_seed(1))
            return x * 2
        findings, metrics = _rng(bad, torch.ones(4))
        assert _rules(findings) == ["R003"] and metrics["dead_draws"] == 1

        def good(x):
            return x * torch.rand(4, generator=torch.Generator())
        assert _rng(good, torch.ones(4))[0] == []

    def test_in_place_draw_read_later_clean(self):
        def dropout(x):
            g = torch.Generator().manual_seed(3)
            mask = torch.empty_like(x).bernoulli_(0.5, generator=g)
            return x * mask
        findings, metrics = _rng(dropout, torch.ones(8))
        assert findings == [] and metrics["draws"] == 1

    def test_prefill_sampling_canary(self):
        """The old generate shape: sample during prefill and drop the
        sample, with a generator re-made from the seed for the decode loop.
        The R-pass must flag both the reuse and the discarded draws."""
        from repro_torch.serve.decode import sample_tokens

        def old_generate(emb):
            g = torch.Generator().manual_seed(0)
            for t in range(emb.shape[0]):      # prefill: sample & discard
                sample_tokens(emb[t][None, None], g, temperature=0.7)
            g = torch.Generator().manual_seed(0)
            toks = [sample_tokens(emb[-1][None, None], g, temperature=0.7)
                    for _ in range(3)]
            return torch.cat(toks)

        findings, metrics = _rng(old_generate, torch.zeros(2, 7))
        rules = _rules(findings)
        assert "R001" in rules and "R003" in rules
        assert metrics["dead_draws"] == 2

    def test_fixed_prefill_clean(self):
        from repro_torch.serve.decode import sample_tokens

        def new_generate(emb):
            g = torch.Generator().manual_seed(0)   # prefill draws nothing
            toks = [sample_tokens(emb[-1][None, None], g, temperature=0.7)
                    for _ in range(3)]
            return torch.cat(toks)

        findings, metrics = _rng(new_generate, torch.zeros(2, 7))
        assert findings == [] and metrics["dead_draws"] == 0

    def test_registered_serve_entry_draws_once_a_step(self):
        """``generate`` prefills by decode without a draw, then draws once a
        decode step, each from a fresh generator state."""
        trace = ga.trace_entry(entrypoints.serve_decode_generate)
        findings, metrics = audit_entry_rng(
            entrypoints.serve_decode_generate, trace)
        assert findings == []
        assert metrics["draws"] == metrics["states"] == 3
        # 5 decode steps of about the same ops: the prompt's 2 (no draw)
        # come before the first draw
        assert metrics["first_draw_op"] > 2 * len(trace.ops) / 5

    def test_engine_dropout_draws_fresh_states(self):
        findings, metrics = audit_entry_rng(entrypoints.engine_sequential)
        assert findings == []
        assert metrics["draws"] == metrics["states"] > 0


# ================================================ W-pass (races + lists)
class TestRaceAudit:
    def _launch(self, accum_axes):
        out = la.Output("out", (8, 8), lambda x, y, z: [((0, 8), (0, 8))],
                        accum_axes=accum_axes)
        return la.Launch("k", "v", "x.cu", "1kE", (1, 3, 1), 256, 0, 0,
                         (256, 0), outputs=(out,))

    def test_w001_undeclared_revisit_flagged(self):
        findings = check_launch_races(self._launch(()), where="t")
        assert _rules(findings) == ["W001"]

    def test_w001_declared_accum_axis_clean(self):
        assert check_launch_races(self._launch((1,)), where="t") == []

    def test_w001_overlapping_row_blocks_flagged(self):
        """K2's row blocks with a stride one row short of their height."""
        out = la.Output("dlogp", (64, 40), lambda x, y, z: [
            ((x * 15, min(x * 15 + 16, 64)), (0, 40))])
        ln = la.Launch("k", "v", "x.cu", "1kE", (5, 1, 1), 256, 0, 0,
                       (256, 0), outputs=(out,))
        assert _rules(check_launch_races(ln, where="t")) == ["W001"]

    def test_w002_duplicate_tile(self):
        findings = check_tile_list([0, 0, 1], [1, 1, 0], [1, 1, 1], 2,
                                   where="t", name="l")
        assert "W002" in _rules(findings)

    def test_w003_unsorted_major(self):
        findings = check_tile_list([1, 0], [0, 0], [1, 1], 2,
                                   where="t", name="l")
        assert "W003" in _rules(findings)

    def test_w004_unvisited_line(self):
        findings = check_tile_list([0, 0], [0, 1], [1, 1], 2,
                                   where="t", name="l")
        assert _rules(findings) == ["W004"]

    def test_w004_occupancy_mismatch(self):
        occ = np.array([[True, True], [False, True]])
        findings = check_tile_list([0, 1], [0, 1], [1, 1], 2,
                                   occ=occ, where="t", name="l")
        assert "W004" in _rules(findings)

    def test_sentinel_and_padding_clean(self):
        findings = check_tile_list([0, 1, 1], [0, 0, 0], [1, 0, 0], 2,
                                   where="t", name="l")
        assert findings == []

    def test_seeded_layout_clean_and_corrupted_duplicate_flagged(self):
        rng = np.random.default_rng(0)
        occ = rng.random((6, 6)) < 0.35
        layout = layout_from_occupancy(occ, 32, list_len=48)
        assert check_layout(layout, where="t") == []
        rows, cols = np.array(layout.rows), np.array(layout.cols)
        idx = np.nonzero(np.array(layout.valid))[0]
        rows[idx[1]], cols[idx[1]] = rows[idx[0]], cols[idx[0]]
        findings = check_tile_list(rows, cols, layout.valid, layout.nt,
                                   where="t", name="l")
        assert "W002" in _rules(findings)

    def test_full_pass_clean_on_repo(self):
        findings, metrics = audit_races()
        assert findings == []
        assert metrics["launches_checked"] > 0
        assert metrics["output_blocks_proven"] > 0
        assert metrics["tiles_proven_race_free"] > 0

    def test_finding_is_the_shared_record(self):
        from repro_torch import analysis
        from repro_torch.analysis import findings, race_audit
        assert race_audit.Finding is findings.Finding is analysis.Finding
        (f,) = check_tile_list([1, 0], [0, 0], [1, 1], 2, where="w",
                               name="l")
        assert f.pass_name == "race"
        assert f.fingerprint == "race:W003:w:l:unsorted"

    def test_blocksparse_validate_kwarg(self):
        from repro_torch.kernels.ops import graph_regularizer_blocksparse

        W = np.kron(np.eye(3), np.ones((2, 2))).astype(np.float32)
        occ = W.reshape(3, 2, 3, 2).any((1, 3))
        layout = layout_from_occupancy(occ, 2)
        logp = torch.log(torch.full((6, 4), 0.25))
        out = graph_regularizer_blocksparse(
            logp, torch.from_numpy(W), 1e-3, 1e-4, layout=layout,
            validate=True)
        assert np.isfinite(float(out))
        arrs = [np.array(a) for a in layout.arrays()]
        idx = np.nonzero(arrs[2])[0]
        arrs[0][idx[1]], arrs[1][idx[1]] = arrs[0][idx[0]], arrs[1][idx[0]]
        with pytest.raises(ValueError, match="W002"):
            graph_regularizer_blocksparse(
                logp, torch.from_numpy(W), 1e-3, 1e-4, layout=tuple(arrs),
                validate=True)


# ==================================================== D-pass (determinism)
class TestDeterminismAudit:
    def _scatter(self, op: str, n_idx: int, dtype=torch.float32, **kw):
        def f(x, idx):
            src = torch.ones(idx.shape[0], dtype=dtype)
            if op == "index_add":
                return x.index_add_(0, idx, src)
            if op == "scatter_add":
                return x.scatter_add(0, idx, src)
            if op == "scatter_reduce":
                return x.scatter_reduce(0, idx, src, reduce="sum")
            return x.index_put_((idx,), src, accumulate=True)
        idx = torch.arange(n_idx) % 4
        return EntryPoint("scatter", lambda: (
            f, (torch.zeros(8, dtype=dtype), idx)), **kw)

    @pytest.mark.parametrize("op", ["index_add", "scatter_add",
                                    "scatter_reduce", "index_put"])
    def test_d001_colliding_float_scatter_flagged(self, op):
        findings, metrics = audit_entry_determinism(self._scatter(op, 8))
        assert _rules(findings) == ["D001"]
        assert metrics["scatters_checked"] == 1

    def test_d001_opt_out_entry_clean(self):
        findings, _ = audit_entry_determinism(
            self._scatter("index_add", 8, deterministic=False))
        assert findings == []

    def test_d001_unique_indices_clean(self):
        findings, metrics = audit_entry_determinism(
            self._scatter("index_add", 4))
        assert findings == [] and metrics["scatters_checked"] == 1

    def test_d001_int_scatter_clean(self):
        findings, _ = audit_entry_determinism(
            self._scatter("index_add", 8, dtype=torch.int32))
        assert findings == []

    def test_registered_entries_clean(self):
        for entry in entrypoints.ENTRY_POINTS[:6]:
            findings, _ = audit_entry_determinism(entry)
            assert findings == [], entry.name

    def _host(self, tmp_path, source, used=None):
        (tmp_path / "m.py").write_text(textwrap.dedent(source))
        return audit_seeded_modules({"m": "m.py"}, root=str(tmp_path),
                                    used=used)

    def test_d002_set_iteration_flagged(self, tmp_path):
        findings, _ = self._host(tmp_path, HOST_FIXTURES["set_for"])
        assert _rules(findings) == ["D002"]

    def test_d002_sorted_iteration_clean(self, tmp_path):
        assert self._host(tmp_path, HOST_FIXTURES["sorted_for"])[0] == []

    def test_d002_tiebreak_and_materialization(self, tmp_path):
        findings, _ = self._host(tmp_path, HOST_FIXTURES["tiebreak"])
        assert _rules(findings) == ["D002", "D002", "D002"]

    def test_d003_global_entropy_flagged(self, tmp_path):
        findings, _ = self._host(tmp_path, HOST_FIXTURES["entropy"])
        assert _rules(findings) == ["D003", "D003", "D003", "D003"]

    def test_d003_seeded_generator_clean(self, tmp_path):
        assert self._host(tmp_path, HOST_FIXTURES["seeded"])[0] == []

    def test_d003_torch_global_generator_flagged(self, tmp_path):
        findings, _ = self._host(tmp_path, """
            import torch

            def noisy(n):
                torch.manual_seed(0)
                a = torch.rand(n)
                b = torch.randperm(n)
                c = torch.bernoulli(a)
                return a, b, c
        """)
        assert _rules(findings) == ["D003"] * 4
        assert {f.detail for f in findings} == {
            "noisy:torch-manual_seed", "noisy:torch-rand",
            "noisy:torch-randperm", "noisy:torch-bernoulli"}

    def test_d003_torch_generator_clean(self, tmp_path):
        assert self._host(tmp_path, """
            import torch

            def quiet(n, seed):
                g = torch.Generator().manual_seed(seed)
                return torch.rand(n, generator=g), torch.randperm(
                    n, generator=g)
        """)[0] == []

    def test_line_waiver_suppresses_and_is_recorded(self, tmp_path):
        used: set = set()
        findings, metrics = self._host(tmp_path, HOST_FIXTURES["waived"],
                                       used=used)
        assert findings == []
        assert metrics["suppressed"] == 1 and len(used) == 1

    def test_seeded_modules_clean_on_repo(self):
        used: set = set()
        findings, metrics = audit_seeded_modules(root=REPO_ROOT, used=used)
        assert findings == []
        assert metrics["seeded_modules_scanned"] == 5
        # partition.py carries the reference's two waived D002 sites
        assert metrics["suppressed"] >= 2
        assert {(os.path.basename(p), line) for p, line, _ in used} >= {
            ("partition.py", 149), ("partition.py", 173)}

    @pytest.mark.parametrize("name", sorted(
        ["set_for", "sorted_for", "tiebreak", "entropy", "seeded",
         "waived"]))
    def test_fingerprints_match_the_reference(self, tmp_path, name):
        """The same fixture sources give the same D002/D003 fingerprints
        through both packages."""
        from repro.analysis.determinism_audit import (
            audit_seeded_modules as ref_sweep)
        (tmp_path / "m.py").write_text(textwrap.dedent(HOST_FIXTURES[name]))
        port, pm = audit_seeded_modules({"m": "m.py"}, root=str(tmp_path))
        ref, rm = ref_sweep({"m": "m.py"}, root=str(tmp_path))
        assert [f.fingerprint for f in port] == \
            [f.fingerprint for f in ref]
        assert pm == rm


HOST_FIXTURES = {
    "set_for": """
        def plan(items):
            pool = set(items)
            out = []
            for x in pool:
                out.append(x)
            return out
    """,
    "sorted_for": """
        def plan(items):
            pool = set(items)
            out = []
            for x in sorted(pool):
                out.append(x)
            return out
    """,
    "tiebreak": """
        def pick(items, deg):
            pool = set(items)
            seed = max(pool, key=lambda u: deg[u])
            order = list(pool)
            first = pool.pop()
            return seed, order, first
    """,
    "entropy": """
        import random
        import time
        import numpy as np

        def noisy():
            np.random.seed(0)
            a = random.random()
            g = np.random.default_rng()
            h = np.random.default_rng(int(time.time()))
            return a, g, h
    """,
    "seeded": """
        import numpy as np

        def quiet(seed):
            g = np.random.default_rng(seed)
            return g.random(4)
    """,
    "waived": """
        def plan(items):
            pool = set(items)
            out = []
            # audit: safe(D002): int-set order is stable in CPython
            for x in pool:
                out.append(x)
            return out
    """,
}


# ====================================================== S-pass (sharding)
def test_sharding_twins_on_a_world_group():
    """S001: a collective on an undeclared group; S002: a gather inside a
    chunk; both clean once declared / opted in; reductions in a chunk are
    allowed by default."""
    import torch.distributed as dist

    def run(coll: str):
        def fn(x):
            for i in range(2):
                with ga.step(i):
                    if coll == "all_gather":
                        out = [torch.empty_like(x)]
                        dist.all_gather(out, x)
                        x = out[0] + 1
                    else:
                        dist.all_reduce(x)
            return x
        fn.chunk_steps = 2
        return fn

    with entrypoints._world_group():
        world = dist.group.WORLD
        x = torch.ones(4)
        bad, metrics = audit_entry_sharding(EntryPoint(
            "s", lambda: (run("all_reduce"), (x.clone(),))))
        assert _rules(bad) == ["S001"] and metrics["collectives_audited"] == 2
        ga.declare_group(world, "data")
        ok, _ = audit_entry_sharding(EntryPoint(
            "s", lambda: (run("all_reduce"), (x.clone(),)),
            mesh_axes=("data",)))
        assert ok == []
        gather, _ = audit_entry_sharding(EntryPoint(
            "s", lambda: (run("all_gather"), (x.clone(),)),
            mesh_axes=("data",)))
        assert _rules(gather) == ["S002"]
        assert gather[0].detail == "loop:all_gather"
        opted, _ = audit_entry_sharding(EntryPoint(
            "s", lambda: (run("all_gather"), (x.clone(),)),
            mesh_axes=("data",),
            allow_loop_collectives=("all_reduce", "all_gather")))
        assert opted == []


def test_s003_carry_placement_changed_flagged():
    def moved(carry):
        with ga.step(0):
            carry["w"] = carry["w"].to("meta")
        return carry
    moved.chunk_steps = 1

    def kept(carry):
        with ga.step(0):
            carry["w"].mul_(2)
        return carry
    kept.chunk_steps = 1
    bad, _ = audit_entry_sharding(EntryPoint(
        "c", lambda: (moved, ({"w": torch.ones(4)},)), donate=0))
    assert _rules(bad) == ["S003"] and bad[0].detail == "w"
    good, _ = audit_entry_sharding(EntryPoint(
        "c", lambda: (kept, ({"w": torch.ones(4)},)), donate=0))
    assert good == []


def test_sync_mesh_gathers_are_waived_with_their_reason():
    """engine_sync_mesh's all_gather a step is S002 by the rule and waived
    next to the entry, with the reason on record."""
    findings, metrics = audit_entry_sharding(entrypoints.engine_sync_mesh)
    assert _rules(findings) == ["S002"]
    assert metrics["collectives_audited"] == entrypoints.CHUNK_STEPS
    waivers = scan_waivers(os.path.join(
        REPO_ROOT, "src/repro_torch/analysis/entrypoints.py"),
        relpath="entrypoints.py")
    (w,) = [w for w in waivers if w.rule == "S002"]
    assert w.scope == "engine_sync_mesh" and "rank" in w.reason
    assert apply_waivers(findings, waivers) == []


# ================================================= waivers / A001 / CLI
class TestWaivers:
    def test_scoped_waiver_matches_where_glob(self, tmp_path):
        path = tmp_path / "w.py"
        path.write_text(
            "# audit: safe(R001@engine_*): replay is intentional here\n")
        waivers = scan_waivers(str(path), relpath="w.py")
        assert len(waivers) == 1 and waivers[0].scope == "engine_*"
        hit = Finding("rng", "R001", "engine_capture", "m")
        miss = Finding("rng", "R001", "serve_decode_generate", "m")
        used: set = set()
        assert apply_waivers([hit, miss], waivers, used=used) == [miss]
        assert used == {waivers[0].key}

    def test_stale_waiver_becomes_a001(self, tmp_path):
        path = tmp_path / "w.py"
        path.write_text("# audit: safe(D002): no longer needed\n")
        waivers = scan_waivers(str(path), relpath="w.py")
        stale = stale_waiver_findings(waivers, set(), ("determinism",))
        assert _rules(stale) == ["A001"]
        assert stale_waiver_findings(waivers, set(), ("vmem",)) == []
        assert stale_waiver_findings(
            waivers, {waivers[0].key}, ("determinism",)) == []

    def test_docstring_examples_are_not_waivers(self, tmp_path):
        path = tmp_path / "w.py"
        path.write_text('"""# audit: safe(C001): only an example"""\n')
        assert scan_waivers(str(path)) == []

    @pytest.mark.parametrize("rel", [
        "src/repro_torch/core/partition.py",
        "src/repro_torch/analysis/entrypoints.py",
        "src/repro/core/partition.py"])
    def test_scanner_matches_the_reference(self, rel):
        """Both packages' scanners give the same Waivers on one file."""
        from repro.analysis.waivers import scan_waivers as ref_scan
        path = os.path.join(REPO_ROOT, rel)
        port = scan_waivers(path, relpath=rel)
        ref = ref_scan(path, relpath=rel)
        assert [(w.path, w.line, w.rule, w.scope, w.reason) for w in port] \
            == [(w.path, w.line, w.rule, w.scope, w.reason) for w in ref]
        assert port


def test_cli_only_alias_and_github_format(tmp_path, monkeypatch, capsys):
    bad = Finding("vmem", "V001", "pad_classes/x", "footprint too big",
                  line=7, path="src/repro_torch/analysis/launch_audit.py")

    def fake_vmem(report, *_):
        report.extend("vmem", [bad], {"launches_checked": 1})

    monkeypatch.setattr(cli, "_run_vmem", fake_vmem)
    args = ["--only", "vmem", "--format", "github", "--device", "cpu",
            "--report", str(tmp_path / "report.json"),
            "--baseline", str(tmp_path / "baseline.json")]
    assert cli.main(args) == 1
    out = capsys.readouterr().out
    assert ("::error file=src/repro_torch/analysis/launch_audit.py,line=7::"
            "[V001] pad_classes/x: footprint too big") in out


@pytest.mark.parametrize("passes", ["race", "concurrency,determinism",
                                    "rng,sharding"])
def test_cli_pass_subsets_clean_on_repo(tmp_path, passes):
    import json
    report = str(tmp_path / "report.json")
    assert cli.main(["--only", passes, "--device", "cpu",
                     "--report", report,
                     "--baseline", str(tmp_path / "baseline.json")]) == 0
    data = json.load(open(report))
    assert set(data["passes"]) == set(passes.split(",")) | {"waivers"}


def test_cli_rejects_unknown_pass():
    with pytest.raises(SystemExit):
        cli.main(["--only", "nonsense", "--device", "cpu"])
