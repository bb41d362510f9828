"""``meta`` stand-ins for every model input: the dry run's inputs.

Port of ``repro/launch/inputs.py``.  ``input_specs(arch, shape, mesh,
strategy)`` returns ``{"fn", "args", "specs", "donate"}``: ``fn`` is the
step to trace (``lm_train_step``, ``prefill`` or ``serve_step``),
``args`` its arguments as ``meta`` tensors with the reference's shapes and
dtypes (nothing is allocated; the train step's SSL head takes the
``"auto"`` regularizer, K1 and K2, whose shape rules the dry run counts),
``specs`` the
:mod:`repro_torch.sharding.specs` spec of every tensor leaf by argument
(``{"params": {path: spec}, ...}``; the optimizer state's follow the
params'), and ``donate`` the arguments the step overwrites (the port's
optimizer and decode cache update in place).

The reference also passes an ``act_sharding`` constraint into the model;
the port's model code takes no sharding constraint, so there is no
counterpart.  Decode passes an explicit ``torch.Generator`` where the
reference passes a ``PRNGKey`` (greedy decode draws nothing from it).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import (INPUT_SHAPES, InputShape,
                                        config_for_shape)
from repro_torch.core.ssl_loss import SSLHyper
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adagrad
from repro_torch.serve.decode import serve_step
from repro_torch.sharding import specs as sh
from repro_torch.train.train_step import lm_train_step

__all__ = ["SSL_GROUPS", "train_inputs", "prefill_inputs", "decode_inputs",
           "step_inputs", "input_specs"]

SSL_GROUPS = 16          # G concatenated meta-batches per global train batch


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _modality(cfg: ModelConfig, B: int) -> dict:
    if not cfg.modality_tokens:
        return {}
    return {"modality_embeds": _meta(
        (B, cfg.modality_tokens, cfg.modality_dim), torch.bfloat16)}


def _batch_spec(mesh, B: int) -> sh.PartitionSpec:
    ba = sh.batch_axes(mesh)
    bn = 1
    for a in ba:
        bn *= mesh.shape[a]
    if B % bn == 0 and B >= bn:
        return sh.PartitionSpec(ba if len(ba) > 1 else ba[0])
    return sh.PartitionSpec()


def train_inputs(cfg: ModelConfig, shape: InputShape, mesh, strategy: str,
                 *, ssl: bool = True) -> dict[str, Any]:
    B, T = shape.global_batch, shape.seq_len
    batch = {
        "tokens": _meta((B, T), torch.int32),
        "targets": _meta((B, T), torch.int32),
        "loss_mask": _meta((B, T), torch.float32),
    }
    if ssl:
        G = min(SSL_GROUPS, B)
        b = B // G
        batch.update(
            W=_meta((G, b, b), torch.float32),
            seq_labels=_meta((G, b), torch.int32),
            seq_label_mask=_meta((G, b), torch.float32),
        )
    batch.update(_modality(cfg, B))
    params = tf.abstract_params(cfg)
    opt = adagrad()
    opt_state = opt.init(params)
    hyper = SSLHyper(gamma=1e-3, kappa=1e-4, weight_decay=0.0) if ssl else None

    def step(params, opt_state, batch):
        return lm_train_step(params, opt_state, batch, cfg=cfg, hyper=hyper,
                             opt=opt, lr=1e-3, pairwise="auto")

    return {"fn": step, "args": (params, opt_state, batch),
            "specs": {"params": sh.param_shardings(params, mesh, strategy),
                      "opt_state": sh.param_shardings(opt_state, mesh,
                                                      strategy),
                      "batch": sh.train_batch_shardings(batch, mesh)},
            "donate": (0, 1)}


def prefill_inputs(cfg: ModelConfig, shape: InputShape, mesh,
                   strategy: str) -> dict[str, Any]:
    """Inference prefill: full-sequence forward that fills the decode
    cache."""
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((B, S), torch.int32), **_modality(cfg, B)}
    params = tf.abstract_params(cfg)

    def step(params, batch):
        return tf.prefill(params, cfg, batch["tokens"],
                          modality_embeds=batch.get("modality_embeds"))

    return {"fn": step, "args": (params, batch),
            "specs": {"params": sh.param_shardings(params, mesh, strategy),
                      "batch": sh.train_batch_shardings(batch, mesh)},
            "donate": ()}


def decode_inputs(cfg: ModelConfig, shape: InputShape, mesh,
                  strategy: str) -> dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    cache = tf.init_cache(cfg, B, S, device="meta")
    params = tf.abstract_params(cfg)
    tokens = _meta((B, 1), torch.int32)
    pos = _meta((B,), torch.int32)
    generator = torch.Generator()
    tok_spec = _batch_spec(mesh, B)

    def step(params, cache, tokens, pos, generator):
        return serve_step(params, cfg, cache, tokens, pos, generator,
                          temperature=0.0)

    return {"fn": step, "args": (params, cache, tokens, pos, generator),
            "specs": {"params": sh.param_shardings(params, mesh, strategy),
                      "cache": sh.cache_shardings(cache, mesh, B, strategy),
                      "tokens": {"": tok_spec}, "pos": {"": tok_spec}},
            "donate": (1,)}


def step_inputs(cfg: ModelConfig, shape: InputShape, mesh,
                strategy: str = "fsdp_tp", *, ssl: bool = True
                ) -> dict[str, Any]:
    """:func:`input_specs` of a config (the dry run's traces at a cut
    depth)."""
    if shape.kind == "train":
        return train_inputs(cfg, shape, mesh, strategy, ssl=ssl)
    if shape.kind == "prefill":
        return prefill_inputs(cfg, shape, mesh, strategy)
    return decode_inputs(cfg, shape, mesh, strategy)


def input_specs(arch: str, shape_name: str, mesh, strategy: str = "fsdp_tp",
                *, ssl: bool = True) -> dict[str, Any]:
    shape = INPUT_SHAPES[shape_name]
    return step_inputs(config_for_shape(get_config(arch), shape), shape,
                       mesh, strategy, ssl=ssl)
