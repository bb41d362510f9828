"""The program's span recorder (``repro_torch.spans``) on the CPU: off it
records nothing and costs one shared no-op; on (a profiler window, or
``spans.recording()``) a prefill records its span tree; recording leaves
the prefill's outputs bit for bit; ``serve_lm --spans`` writes them."""
import json
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.kernels.boundary import bounded, current
from repro_torch.kernels.flash_attention import flash_attention_gqa
from repro_torch.models import transformer as tf
from repro_torch.serve import serve_lm
from repro_torch.serve.decode import sample_tokens

#: The children of each span of a prefill ("layer": one a decoder layer;
#: ``attn.cache`` twice: the sequence's cache, then its padding to
#: ``cache_len``).
CHILDREN = {
    "prefill": ["prefill.embed", "layer", "prefill.cache_stack",
                "prefill.head"],
    "layer": ["attn", "ffn"],
    "attn": ["attn.norm", "attn.qkv", "attn.rope", "kernel.flash_attention",
             "attn.out", "attn.cache", "attn.cache"],
    "ffn": ["ffn.norm", "ffn.mlp"],
    "prefill.head": ["head.norm"],
    # The prefill's norms run K14's wrapper, which opens its kernel span.
    **{name: ["kernel.rms_norm"]
       for name in ("attn.norm", "ffn.norm", "head.norm")},
}


@pytest.fixture(scope="module")
def model():
    cfg = get_config("qwen2-1.5b").reduced()
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(1))
    return cfg, params, toks


@pytest.fixture(autouse=True)
def no_spans():
    spans.clear()
    yield
    spans.clear()


def _request(model):
    cfg, params, toks = model
    out, cache = tf.prefill(params, cfg, toks, cache_len=28)
    tok = sample_tokens(out["logits"][:, -1:])
    return out, cache, tok


def test_off_records_nothing_and_returns_the_shared_no_op(model):
    assert spans.span("attn.rope", device=True) is spans._OFF
    assert spans.span("layer", i=3) is spans._OFF
    assert spans.request("prefill", batch=2) is spans._OFF
    assert spans.request("sample", new=False) is spans._OFF
    _request(model)
    assert spans.records() == []


def test_an_off_span_lets_an_exception_through():
    with pytest.raises(KeyError, match="through"):
        with spans.span("attn"):
            raise KeyError("through")


@pytest.mark.parametrize("how", ["profiler", "recording"])
def test_on_under_a_profiler_window_and_recording(model, how):
    if how == "profiler":
        with profile(activities=[ProfilerActivity.CPU]):
            _request(model)
    else:
        with spans.recording():
            _request(model)
    names = [r["name"] for r in spans.records()]
    assert names.count("prefill") == 1 and names[-1] == "sample"
    assert spans.span("attn") is spans._OFF


def test_a_prefills_span_tree(model):
    cfg = model[0]
    with spans.recording():
        for _ in range(2):
            _request(model)
    recs = spans.records()
    reqs = spans.requests()
    assert len(reqs) == 2
    by_id = {r["id"]: r for r in recs}
    tops = [r for r in recs if r["name"] == "prefill"]
    assert [t["id"] for t in tops] == sorted(reqs) and tops[0]["id"] != \
        tops[1]["id"]
    for top in tops:
        mine = reqs[top["id"]]
        assert top["req"] == top["id"] and top["parent"] is None
        assert top["attrs"] == {"batch": 2, "tokens": 24}
        assert all(r["req"] == top["id"] for r in mine)
        layers = [r for r in mine if r["name"] == "layer"]
        assert [r["attrs"] for r in layers] == [
            {"i": i} for i in range(cfg.n_layers)]
        kids: dict = {}
        for r in mine:
            if r["parent"] is not None:
                parent = by_id[r["parent"]]
                assert parent["req"] == top["id"]
                assert parent["start"] <= r["start"] <= r["end"] <= \
                    parent["end"]
                kids.setdefault(r["parent"], []).append(r)
        for r in mine:
            want = [n for name in CHILDREN.get(r["name"], [])
                    for n in [name] * (cfg.n_layers if name == "layer"
                                       else 1)]
            got = sorted(kids.get(r["id"], []), key=lambda k: k["start"])
            assert [k["name"] for k in got] == want, r["name"]
        (sample,) = [r for r in mine if r["name"] == "sample"]
        assert sample["parent"] is None and sample["start"] >= top["end"]
    # Without a device, no span has a device interval nor an anchor.
    assert all(r["dev"] is None and "anchor_err" not in r for r in recs)


def test_records_keeps_the_spans_inside_the_window(model):
    with spans.recording():
        _request(model)
        cut = spans.records()[-1]["end"]
        _request(model)
    first, second = sorted(spans.requests())
    assert list(spans.requests(hi=cut)) == [first]
    assert list(spans.requests(lo=cut)) == [second]
    assert all(r["start"] >= cut for r in spans.records(lo=cut))


def test_bounded_opens_a_kernel_span_only_while_recording():
    q = torch.randn(1, 8, 2, 16)
    k = v = torch.randn(1, 8, 1, 16)
    seen = []

    @bounded("probe")
    def wrapper():
        seen.append(current())
        return flash_attention_gqa(q, k, v)

    wrapper()
    assert spans.records() == []
    with spans.recording():
        wrapper()
    assert seen == ["probe", "probe"] and current() is None
    recs = spans.records()
    assert [r["name"] for r in recs] == ["kernel.flash_attention",
                                         "kernel.probe"]
    assert recs[0]["parent"] == recs[1]["id"]


def test_recording_is_per_thread(model):
    other = []

    def run():
        other.append(spans.span("attn"))

    with spans.recording():
        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=30)
        mine = spans.span("attn")
    assert not t.is_alive()
    assert other == [spans._OFF] and mine is not spans._OFF


def test_recording_leaves_the_prefill_bit_for_bit(model):
    out, cache, tok = _request(model)
    with spans.recording():
        out_on, cache_on, tok_on = _request(model)
    assert torch.equal(out["logits"], out_on["logits"])
    assert torch.equal(tok, tok_on)
    for a, b in zip(cache["layers"], cache_on["layers"]):
        for f in ("k", "v", "positions", "valid"):
            assert torch.equal(getattr(a, f), getattr(b, f))


def test_span_table_takes_self_time_and_the_median_over_requests():
    recs = []
    for req, scale in ((0, 1.0), (10, 3.0), (20, 2.0)):
        recs += [
            {"name": "prefill", "id": req, "req": req, "parent": None,
             "start": 0.0, "end": 10.0 * scale, "dev": [0.0, 12.0 * scale]},
            {"name": "layer", "id": req + 1, "req": req, "parent": req,
             "start": 1.0, "end": 1.0 + 4.0 * scale, "dev": None},
            {"name": "layer", "id": req + 2, "req": req, "parent": req,
             "start": 5.0, "end": 5.0 + 2.0 * scale, "dev": None}]
    table = serve_lm.span_table(recs)
    assert table["prefill"] == {"host_ms": 2e4, "host_self_ms": 8e3,
                                "device_ms": 2.4e4, "count": 1}
    assert table["layer"] == {"host_ms": 1.2e4, "host_self_ms": 1.2e4,
                              "device_ms": 0.0, "count": 2}


def test_serve_lm_spans_writes_readable_json(tmp_path, capsys):
    path = tmp_path / "spans.json"
    stats = serve_lm.main(["--device", "cpu", "--reduced", "--batch", "2",
                           "--prompt-len", "16", "--steps", "2",
                           "--spans", str(path)])
    recs = json.loads(path.read_text())
    n_layers = get_config("qwen2-1.5b").reduced().n_layers
    names = [r["name"] for r in recs]
    assert names.count("prefill") == names.count("sample") == \
        serve_lm.SPAN_REQUESTS
    assert names.count("layer") == serve_lm.SPAN_REQUESTS * n_layers
    assert stats["spans"]["layer"]["count"] == n_layers
    assert "host self" in capsys.readouterr().out
    assert spans.records() == []
