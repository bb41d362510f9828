"""The readers of the program's spans (``device_ms.{rope,norm,swiglu}.prefill``
and ``idle_ms.program.prefill``) on a synthetic trace and synthetic spans
put into ``repro_torch.spans``'s record: what each reads, the median over
request ids, a trace clock that drifts from the host's, the traced
window's edges, requests whose K11 spans do not hold their kernels, and
None where the spans cannot be put on the trace's clock or nothing was
recorded."""
import importlib.util
import sys

import pytest

from perfbench.harness.trace import Trace
from perfbench.tests.cells import BENCH

spans = pytest.importorskip("repro_torch.spans")

NAMES = ("device_ms.rope.prefill", "device_ms.norm.prefill",
         "device_ms.swiglu.prefill", "idle_ms.program.prefill")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        "perfbench_test_" + name.replace(".", "_"),
        BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


READERS = {name: _load(name) for name in NAMES}


@pytest.fixture(autouse=True)
def record():
    spans.clear()
    yield
    spans.clear()


def _put(name, sid, req, parent, start, end, dev=None, anchor_err=None):
    """A finished span in the recorder's record, times in seconds."""
    cls = spans._Top if anchor_err is not None else spans._Span
    s = cls.__new__(cls)
    s.name, s.id, s.req, s.parent, s.attrs, s.ev = name, sid, req, parent, \
        None, None
    s.t0, s.t1 = round(start * 1e9), round(end * 1e9)
    s.dev = None if dev is None else (dev[0] * 1e9, dev[1] * 1e9)
    if anchor_err is not None:
        s.anchor = (None, s.t0, round(anchor_err * 1e9))
    spans._SPANS.append(s)


#: A layer's spans after its start: name, host interval, device interval.
LAYER = [("attn.norm", (0.0, 0.07), (0.0, 0.1)),
         ("attn.qkv", (0.07, 0.1), None),
         ("attn.rope", (0.1, 0.2), (0.1, 0.2)),
         ("kernel.flash_attention", (0.3, 0.4), (0.3, 0.4)),
         ("ffn.norm", (0.4, 0.5), (0.4, 0.5)),
         ("ffn.mlp", (0.5, 0.8), (0.5, 0.8))]


def _request(t, rope=0.05, flash_at=0.31, layers=2):
    """One request at host time ``t`` (``prefill`` [t, t + 2], layers at t
    and t + 1, ``head.norm`` [t + 1.8, t + 1.9], ``sample`` [t + 2, t +
    2.05]; with more ``layers``, one more second each) -> its kernels: a layer's norms (the
    first ending at .06), RoPE's two (the first ``rope`` long), K11 from
    ``flash_at`` (the first layer's) to .4, the MLP's two GEMMs around a
    SiLU of .05; then the final norm, the token's argmax and its copy.
    Device idle, a layer: [.06, .1] (which starts under ``attn.norm`` and
    has its middle under ``attn.qkv``), RoPE's gap (.01 at the default),
    [.2, .31] under ``prefill`` alone, .02 under ``ffn.norm``; [.8, 1]
    between the layers, .02 under ``head.norm`` and ``sample``: .6 at the
    defaults."""
    sid = round(t * 100)
    end = t + layers
    _put("prefill", sid, sid, None, t, end, dev=(t, end), anchor_err=1e-6)
    kernels, k = [], sid
    for off in map(float, range(layers)):
        for name, host, dev in LAYER:
            k += 1
            _put(name, k, sid, sid, t + off + host[0], t + off + host[1],
                 dev=None if dev is None else (t + off + dev[0],
                                               t + off + dev[1]))
        kernels += [(name, t + off + a, t + off + b) for name, a, b in [
            ("reduce_norm", 0.0, 0.06),
            ("elementwise_rope", 0.1, 0.1 + rope),
            ("elementwise_rope", 0.16, 0.2),
            ("flash_fwd_wgmma", flash_at if off == 0.0 else 0.31, 0.4),
            ("reduce_norm", 0.4, 0.48),
            ("nvjet_gemm", 0.5, 0.6),
            ("silu_kernel", 0.6, 0.65),
            ("nvjet_gemm", 0.65, 0.8)]]
    _put("head.norm", k + 1, sid, sid, end - 0.2, end - 0.1,
         dev=(end - 0.2, end - 0.1))
    _put("sample", k + 2, sid, None, end, end + 0.05)
    return kernels + [("reduce_norm", end - 0.2, end - 0.12),
                      ("argmax", end - 0.1, end + 0.01),
                      ("memcpy_dtoh", end + 0.03, end + 0.04)]


def _ctx(kernels, window=(0.0, 30.0)):
    return {"kind": "prefill", "trace": Trace(kernels=kernels, window=window,
                                              spans=[])}


def _read(name, ctx):
    return READERS[name].read(ctx)


def test_each_reader_reads_its_spans():
    ctx = _ctx(_request(1.0))
    assert _read("device_ms.rope.prefill", ctx) == pytest.approx(180.0)
    assert _read("device_ms.norm.prefill", ctx) == pytest.approx(
        2 * (60.0 + 80.0) + 80.0)
    assert _read("device_ms.swiglu.prefill", ctx) == pytest.approx(100.0)
    assert _read("idle_ms.program.prefill", ctx) == pytest.approx(600.0)


def test_idle_goes_to_the_span_open_at_the_gaps_middle():
    """Each gap inside the request's top spans goes to the innermost span
    open at its middle, whatever span its start lies in; the window's lead
    and what follows the token's copy lie outside them."""
    (idle,) = READERS["idle_ms.program.prefill"].split(
        _ctx(_request(1.0))).values()
    assert idle == pytest.approx({
        "attn.qkv": 0.08, "attn.rope": 0.02, "prefill": 0.42,
        "ffn.norm": 0.04, "head.norm": 0.02, "sample": 0.02}, abs=1e-9)


def test_a_request_is_the_median_over_request_ids():
    kernels = (_request(1.0, rope=0.06) + _request(4.0, rope=0.01)
               + _request(7.0, rope=0.02))
    ctx = _ctx(kernels)
    # RoPE .20, .10, .12 a request (mean .14); idle .58, .68, .66 (.64).
    assert _read("device_ms.rope.prefill", ctx) == pytest.approx(120.0)
    assert _read("idle_ms.program.prefill", ctx) == pytest.approx(660.0)


def test_the_traces_clock_may_drift_from_the_hosts():
    """Kernels on a clock 3 ms ahead of the host's and 0.5 ms a second
    faster: each request's line carries its spans onto it."""
    def skew(t):
        return 3e-3 + t * (1 + 5e-4)
    kernels = [(n, skew(s), skew(e)) for n, s, e in
               _request(1.0) + _request(4.0, rope=0.01)
               + _request(7.0, rope=0.02)]
    ctx = _ctx(kernels)
    assert _read("device_ms.rope.prefill", ctx) == pytest.approx(
        120.0 * (1 + 5e-4))
    assert _read("idle_ms.program.prefill", ctx) == pytest.approx(
        660.0 * (1 + 5e-4))


def test_spans_outside_the_window_are_left_out():
    kernels = _request(1.0) + _request(40.0, rope=0.01)
    ctx = _ctx(kernels, window=(0.5, 30.0))
    assert _read("device_ms.rope.prefill", ctx) == pytest.approx(180.0)
    assert _read("idle_ms.program.prefill", ctx) == pytest.approx(600.0)
    # A request whose top span the window's start cuts is not read.
    assert all(_read(name, _ctx(kernels, window=(1.5, 30.0))) is None
               for name in NAMES)


def test_a_request_whose_k11_intervals_do_not_hold_is_left_out():
    """K11's kernel starting before its interval in one of three requests:
    that request is not read; in two of three, nothing is."""
    late = _request(1.0, rope=0.01, flash_at=0.25)
    ctx = _ctx(late + _request(4.0) + _request(7.0, rope=0.06))
    assert _read("device_ms.rope.prefill", ctx) == pytest.approx(190.0)
    spans.clear()
    ctx = _ctx(_request(1.0, flash_at=0.25) + _request(4.0)
               + _request(7.0, flash_at=0.2))
    assert all(_read(name, ctx) is None for name in NAMES)


@pytest.mark.parametrize("fault", ["extra", "missing", "misfit"])
def test_a_k11_count_or_fit_that_fails_reads_none(fault):
    """A K11 kernel too many or too few in the window, or one ending 0.1
    ms off the line through the others' ends."""
    kernels = _request(1.0, layers=3)
    k11 = [k for k in kernels if "flash" in k[0]]
    if fault == "extra":
        kernels.append(("flash_fwd_wgmma", 1.6, 1.65))
    elif fault == "missing":
        kernels.remove(k11[1])
    else:
        kernels.remove(k11[1])
        kernels.append((k11[1][0], k11[1][1], k11[1][2] - 1e-4))
    assert all(_read(name, _ctx(kernels)) is None for name in NAMES)


def test_within_the_fit_the_interval_holds():
    kernels = _request(1.0, flash_at=0.3 - 2e-6)
    assert _read("device_ms.rope.prefill", _ctx(kernels)) == \
        pytest.approx(180.0)


def test_nothing_recorded_or_no_recorder_reads_none(monkeypatch):
    import repro_torch
    kernels = _request(1.0)
    spans.clear()
    ctx = _ctx(kernels)
    assert all(_read(name, ctx) is None for name in NAMES)
    _request(1.0)
    assert all(_read(name, _ctx([])) is None for name in NAMES)
    assert all(_read(name, dict(ctx, kind="train")) is None
               for name in NAMES)
    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert all(_read(name, ctx) is None for name in NAMES)
