"""``chip_smoke.py``'s tables held to the port's configs, on the CPU.

Every architecture of ``repro_torch.configs`` runs on the card: served
whole by ``serve_phase`` (:data:`chip_smoke.SERVE_ARCH`) or at the cut of
:data:`chip_smoke.FAMILY_CUTS`; :data:`chip_smoke.FAMILY_K11` is each cut's
count of causal self-attention layers without a window or with one that
covers the families' 2,048-token prompt (K11's launches a prefill); every
configuration's vocabulary is an LM head C that ``lm_kernel_phase`` holds
K1 and K2 at; and K11's new head layouts are the served configs' own.
"""
import dataclasses
import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models.config import ATTN, ATTN_SWA  # noqa: E402


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_architecture_is_served_on_the_card(arch):
    assert (arch == cs.SERVE_ARCH) != (arch in cs.FAMILY_CUTS)


@pytest.mark.parametrize("arch", sorted(cs.FAMILY_CUTS))
def test_family_k11_counts_the_causal_layers_of_the_cut(arch):
    over, cut = cs.FAMILY_CUTS[arch]
    cfg = dataclasses.replace(get_config(arch), **over)
    assert cs.FAMILY_K11[arch] == sum(
        k == ATTN or (k == ATTN_SWA and cfg.sliding_window >= 2048)
        for k in cfg.layer_kinds())
    assert (over == {}) == (cut == "nothing")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_vocabulary_is_an_lm_head(arch):
    heads = {C for _, _, C in cs.LM_HEAD_SHAPES}
    assert get_config(arch).vocab_size in heads


@pytest.mark.parametrize("arch", sorted(cs.LAYOUT_ATTN))
def test_k11_layouts_are_the_served_configs(arch):
    """(B, T, H, KV, hd) at the families' prefill (batch 4, prompt 2048),
    whole models: the layout each prefill hands K11."""
    cfg = get_config(arch)
    assert cs.LAYOUT_ATTN[arch] == (4, 2048, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.hd)
    assert cs.FAMILY_CUTS[arch] == ({}, "nothing")
    assert cs.FAMILY_K11[arch] == cfg.n_layers


@pytest.mark.parametrize("arch", sorted(cs.FAMILY_TRAIN))
def test_trained_families_are_configs_with_an_lm_head(arch):
    cfg = dataclasses.replace(get_config(arch), **cs.FAMILY_TRAIN[arch])
    assert cfg.vocab_size in {C for k, B, C in cs.LM_HEAD_SHAPES if k == 1}
    assert cfg.n_layers <= get_config(arch).n_layers


def test_quickstart_rule_lies_between_its_readings():
    """The rule's limits sit above the sound card's largest readings and
    below the planted faults' (the readings written beside the rule)."""
    assert 5.9e-6 < cs.QS_FIRST_RTOL < 3.1e-3
    assert 0.002 < cs.QS_FIRST_ACC < 0.029
    assert 9.6e-4 < cs.QS_RTOL < 0.31
    assert 0.005 < cs.QS_ACC < 0.151
    assert [when for _, _, when in cs.QS_PLANTED] == ["first", "later"]
    first = [(1.0e-3, 0.0)] + [(0.0, 0.0)] * 9
    later = [(0.0, 0.0)] * 9 + [(0.0, 0.04)]
    assert cs.qs_breaks(first, "first") and not cs.qs_breaks(first, "later")
    assert cs.qs_breaks(later, "later") and not cs.qs_breaks(later, "first")


def test_norm_widths_are_the_configs():
    """``norm_kernel_phase`` holds K14 at every configuration's width."""
    assert set(cs.NORM_WIDTHS) == {get_config(a).d_model for a in ARCH_IDS}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_norms_counts_the_prefills_norm_calls(arch, monkeypatch):
    """:func:`chip_smoke.prefill_norms` (the K14 launches the smoke holds a
    served prefill to) is the wrapper's calls in a reduced prefill."""
    import torch
    from repro_torch.kernels import norm
    from repro_torch.models import transformer as tf
    cfg = get_config(arch).reduced()
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 4), dtype=torch.long)
    mod = (torch.zeros((1, cfg.modality_tokens, cfg.modality_dim))
           if cfg.modality_tokens else None)
    calls = []
    wrapper = norm.rms_norm
    monkeypatch.setattr(norm, "rms_norm",
                        lambda x, s, eps=1e-6: calls.append(1) or wrapper(
                            x, s, eps))
    tf.prefill(params, cfg, toks, modality_embeds=mod, cache_len=8)
    assert len(calls) == cs.prefill_norms(cfg)
    full = get_config(arch)
    if full.norm == "rmsnorm" and set(full.layer_kinds()) <= {ATTN, ATTN_SWA}:
        assert cs.prefill_norms(full) == 2 * full.n_layers + 1

