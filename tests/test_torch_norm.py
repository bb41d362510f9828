"""K14 (``repro_torch.kernels.norm``) on the CPU: its plain version is
``apply_norm``'s float32 composite bit for bit, the prefill takes it at its
three norm sites and gives the bits it gave with the composite, training's
``forward`` and ``decode_step`` never call it, and the wrapper refuses what
the kernel does not take.  The kernel itself runs only on the card
(``tests/test_torch_kernels_cuda.py``)."""
import dataclasses
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import leaf_paths  # noqa: E402
from repro_torch.kernels import norm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.layers import common  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: d_model of every configuration of ``repro_torch.configs``.
WIDTHS = (768, 1024, 1536, 2048, 3072, 4096, 7168, 8192)


def parent_norm(p, x, kind="rmsnorm", eps=1e-6):
    """``apply_norm`` as it was before K14, verbatim."""
    xf = x.float()
    if kind == "rmsnorm":
        nrm = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
        return (nrm * p["scale"]).to(x.dtype)
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), -1, keepdim=True)
    nrm = (xf - mu) * torch.rsqrt(var + eps)
    return (nrm * p["scale"] + p["bias"]).to(x.dtype)


def _inputs(rows, d, dtype, seed=0):
    g = torch.Generator().manual_seed(seed + 31 * rows + d)
    mag = torch.exp(torch.randn((rows, 1), generator=g))
    x = (torch.randn((rows, d), generator=g) * mag).to(dtype)
    return x, 1 + 0.1 * torch.randn(d, generator=g)


def test_widths_are_the_configs():
    assert set(WIDTHS) == {get_config(a).d_model for a in ARCH_IDS}


@pytest.mark.parametrize("rows", (1, 7, 64))
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32),
                         ids=("bf16", "f32"))
def test_plain_version_is_the_composite(dtype, d, rows):
    x, scale = _inputs(rows, d, dtype)
    want = parent_norm({"scale": scale}, x)
    for got in (norm.rms_norm(x, scale), norm.rms_norm_ref(x, scale),
                common.apply_norm({"scale": scale}, x)):
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_gives_the_parents_bits(arch, monkeypatch):
    """A reduced config's CPU prefill (logits, every cache or state leaf)
    equals the prefill with the parent's composite at the three norm
    sites, bit for bit; RMSNorm configs reach the wrapper at every site
    (2 · n_layers + 1 where every layer has an FFN), LayerNorm ones
    never."""
    cfg = get_config(arch).reduced()
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    mod = (torch.randn((2, cfg.modality_tokens, cfg.modality_dim),
                       generator=torch.Generator().manual_seed(2))
           if cfg.modality_tokens else None)
    calls = []
    wrapper = norm.rms_norm

    def counted(x, scale, eps=1e-6):
        calls.append(tuple(x.shape))
        return wrapper(x, scale, eps)

    monkeypatch.setattr(norm, "rms_norm", counted)
    out, cache = tf.prefill(params, cfg, toks, modality_embeds=mod,
                            cache_len=16, moe_dispatch="dropless")
    with monkeypatch.context() as m:
        m.setattr(tf, "_prefill_norm", parent_norm)
        want, want_cache = tf.prefill(params, cfg, toks, modality_embeds=mod,
                                      cache_len=16, moe_dispatch="dropless")
    assert torch.equal(out["logits"], want["logits"])
    got_leaves, want_leaves = leaf_paths(cache), leaf_paths(want_cache)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, a), (_, b) in zip(got_leaves, want_leaves):
        assert torch.equal(a, b), path
    if cfg.norm != "rmsnorm":
        assert calls == []
    else:
        assert calls and set(calls) == {(2, 12, cfg.d_model)}
        if all(k in ("attn", "attn_swa") for k in cfg.layer_kinds()):
            assert len(calls) == 2 * cfg.n_layers + 1


def test_forward_and_decode_keep_the_composite(monkeypatch):
    """Training's forward (and its gradient) and a decode step never reach
    K14's wrapper."""
    def refuse(*args, **kwargs):
        raise AssertionError("K14 called outside the prefill")

    cfg = get_config("qwen2-1.5b").reduced()
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    _, cache = tf.prefill(params, cfg, toks, cache_len=12)
    monkeypatch.setattr(norm, "rms_norm", refuse)
    leaves = [t.requires_grad_() for t in
              (params["final_norm"]["scale"], params["embed"]["table"])]
    out = tf.forward(params, cfg, toks)
    out["logits"].float().square().mean().backward()
    assert all(t.grad is not None for t in leaves)
    tf.decode_step(params, cfg, cache, toks[:, -1:],
                   torch.full((2,), 8, dtype=torch.int32))


@pytest.mark.parametrize("case", (
    "ragged row", "float16", "float64", "non-contiguous row", "too wide",
    "scale not float32", "scale of another width", "requires grad"))
def test_check_operands_refuses_what_k14_does_not_take(case):
    x, scale = _inputs(4, 64, torch.bfloat16)
    if case == "ragged row":
        x = x[:, :12].contiguous()      # 24 bytes a row
        scale = scale[:12].contiguous()
    elif case in ("float16", "float64"):
        x = x.to(getattr(torch, case))
    elif case == "non-contiguous row":
        x = _inputs(4, 128, torch.bfloat16)[0][:, ::2]
    elif case == "too wide":
        x, scale = _inputs(2, norm.MAX_D + 64, torch.bfloat16)
    elif case == "scale not float32":
        scale = scale.bfloat16()
    elif case == "scale of another width":
        scale = scale[:32]
    else:
        x = x.float().requires_grad_()
    with pytest.raises((TypeError, ValueError, NotImplementedError)):
        norm.check_operands(x, scale)


def test_check_operands_takes_the_prefills_rows():
    for d in WIDTHS + (128,):
        for dtype in (torch.bfloat16, torch.float32):
            x, scale = _inputs(3, d, dtype)
            norm.check_operands(x.reshape(1, 3, d), scale)


def test_mixed_devices_raise():
    x, scale = _inputs(4, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="one device"):
        norm.rms_norm(x, scale.to("meta"))


def test_meta_tensors_take_the_composite():
    """The dry run traces a prefill on ``meta`` tensors: the wrapper
    gives the composite's shape and dtype, and launches nothing."""
    x = torch.empty((2, 5, 256), dtype=torch.bfloat16, device="meta")
    y = norm.rms_norm(x, torch.empty(256, device="meta"))
    assert y.device.type == "meta" and y.shape == x.shape \
        and y.dtype == x.dtype
    assert norm.launch_counts() == {"rms_norm": 0}


def _constant(name: str) -> int:
    src = (ROOT / norm.SOURCE).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_plan_mirrors_the_source():
    assert (norm.THREADS, norm.VALUES, norm.MAX_WARPS, norm.MAX_D) == tuple(
        _constant(n) for n in ("kThreads", "kValues", "kMaxWarps", "kMaxD"))
    # The four prefill cells (bf16): qwen2 2k and 32k, phi4 2k, mixtral.
    for rows, d, warps, blocks in ((8192, 1536, 2, 2048),
                                   (32768, 1536, 2, 8192),
                                   (8192, 3072, 4, 4096),
                                   (8192, 4096, 4, 4096)):
        p = norm.plan(rows, d, "bfloat16")
        assert (p["warps"], p["blocks"]) == (warps, blocks)
    for dtype in ("float32", "bfloat16"):
        assert norm.plan(7, 8192, dtype)["warps"] == 8
        assert norm.plan(7, 8192, dtype)["blocks"] == 7
        assert norm.plan(7, 1024, dtype)["warps"] == 1


def test_occupancy_kernels_are_every_plan():
    """Every instantiation a width up to MAX_D launches, and no other."""
    tag = {"float32": "f", "bfloat16": "13__nv_bfloat16"}
    plans = {f"15rms_norm_kernelI{tag[dt]}Li{norm.plan(1, d, dt)['warps']}E"
             for d in range(8, norm.MAX_D + 1, 8)
             for dt in ("float32", "bfloat16")}
    assert plans == set(norm.OCCUPANCY_KERNELS)


def test_reduced_config_dtypes_keep_their_bits_in_bf16():
    """The served dtype: a bf16 reduced prefill through the wrapper equals
    the parent's composite too."""
    cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(),
                              dtype="bfloat16")
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    out, _ = tf.prefill(params, cfg, toks, cache_len=16)
    orig = tf._prefill_norm
    try:
        tf._prefill_norm = parent_norm
        want, _ = tf.prefill(params, cfg, toks, cache_len=16)
    finally:
        tf._prefill_norm = orig
    assert out["logits"].dtype == torch.bfloat16
    assert torch.equal(out["logits"], want["logits"])
