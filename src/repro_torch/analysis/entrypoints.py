"""The audited entry points: every contract the trace passes prove.

The port's counterpart of the reference's ``entrypoints.py``: the same
eleven entries by the same names and sizes (B = 256, C = 39).  Each
:class:`~repro_torch.analysis.graph_audit.EntryPoint` names one surface of
the port with its committed expectations — the fused Eq.-3/4 forward and
backward (gradients to logp *and* W, so K1, K2 and K3 run) at **0** (B, B)
outputs outside a kernel boundary, the plain ``kernels/ref.py``
regularizer kept as a canary that must still trip the counter, the
streaming k-NN with no (N, M) buffer, one engine chunk per execution
strategy with its carry updated in place and no host sync inside the
chunk, and the sampled decode loop drawing one fresh generator state a
step.

Entries are exposed through the ``repro_torch.api.registry.AUDIT``
registry.  Builders make tiny but faithful instances (the real kernel
wrappers, engine and strategies, small shapes) on :func:`device` — the
card unless :func:`set_device` asked for the CPU, as the CLI's
``--device`` does — and the auditor runs each once under the recorder.

Engine entries run one chunk of :data:`CHUNK_STEPS` steps through the
engine's own guarded loop (``Engine._guarded_steps``, a guard window of
one chunk), each step marked for the recorder through the engine's
``step_scope``.  The guard's one fetch a window falls after the chunk's
last step, outside the chunk.

Inputs are drawn from fixed seeds (:func:`_seeded`): the trace passes read
only shapes, storages and generator states, but the card's bit-for-bit
reruns need values on which an order-dependent sum would show.

Scoped waivers of entry-level findings live here, next to the entries.
"""
from __future__ import annotations

import contextlib
import gc
import shutil
import tempfile

import numpy as np
import torch
from torch.utils._pytree import tree_map

from repro_torch.analysis.graph_audit import EntryPoint, declare_group, step

__all__ = [
    "ENTRY_POINTS",
    "CHUNK_STEPS",
    "set_device",
    "device",
    "graph_reg_fused",
    "graph_reg_blocksparse",
    "graph_reg_ref",
    "knn_topk",
    "online_refresh",
    "ssl_objective",
    "engine_sequential",
    "engine_sync_mesh",
    "engine_async_ps",
    "engine_capture",
    "serve_decode_generate",
]

_B, _C = 256, 39                      # regularizer block: paper's 39 phones
_GAMMA, _KAPPA = 1e-3, 1e-4
#: Steps of the engine entries' chunk (``scan_chunk``).
CHUNK_STEPS = 2
#: The process-group role of the engine's data group (S001).
DATA_GROUP = "data"

_DEVICE = ["cuda"]


def set_device(dev: str) -> None:
    """Run the entries on ``dev`` ("cuda" or "cpu")."""
    from repro_torch.device import resolve_device
    _DEVICE[0] = str(resolve_device(dev))


def device() -> torch.device:
    """The entries' device: the card unless :func:`set_device` asked for
    the CPU; raises without a GPU."""
    from repro_torch.device import resolve_device
    return resolve_device(_DEVICE[0])


def _seeded(seed: int, *shape: int) -> torch.Tensor:
    """Standard normal float32 values of ``shape`` from numpy ``seed``, on
    :func:`device`."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                            ).to(device())


def _affinity(seed: int, b: int = _B) -> torch.Tensor:
    """A symmetric (b, b) affinity block in [0, 1) from numpy ``seed``."""
    rng = np.random.default_rng(seed)
    W = rng.random((b, b), dtype=np.float32)
    return torch.from_numpy((W + W.T) / 2).to(device())


def _logp_W(b: int = _B, c: int = _C):
    logp = torch.log_softmax(_seeded(0, b, c), dim=-1)
    return logp, _affinity(1, b)


def _grads_of(loss_fn):
    """``(logp, W) -> (loss, (dlogp, dW))``: gradients to both."""
    def run(logp, W):
        lp = logp.detach().requires_grad_(True)
        w = W.detach().requires_grad_(True)
        loss = loss_fn(lp, w)
        return loss.detach(), torch.autograd.grad(loss, (lp, w))
    return run


def _build_fused():
    from repro_torch.kernels.ops import graph_regularizer_fused

    return _grads_of(lambda lp, w: graph_regularizer_fused(
        lp, w, _GAMMA, _KAPPA)), _logp_W()


def _build_blocksparse():
    """Block-sparse forward and backward on a block-diagonal mask (2 of 4
    tiles active): K4, then K5 → K6 for dlogp and K7 for dW, 0 (B, B)
    outputs outside the kernels in either direction."""
    from repro_torch.core.metabatch import block_layout
    from repro_torch.kernels.ops import graph_regularizer_blocksparse

    bt = _B // 2
    logp, W = _logp_W()
    mask = torch.zeros(_B, _B, device=W.device)
    mask[:bt, :bt] = 1.0
    mask[bt:, bt:] = 1.0
    W = W * mask
    layout = block_layout(W.cpu().numpy(), bt)
    return _grads_of(lambda lp, w: graph_regularizer_blocksparse(
        lp, w, _GAMMA, _KAPPA, layout=layout)), (logp, W)


def _build_ref():
    from repro_torch.kernels.ref import graph_regularizer_ref

    return _grads_of(lambda lp, w: graph_regularizer_ref(
        lp, w, _GAMMA, _KAPPA)), _logp_W()


def _build_knn():
    from repro_torch.kernels.ops import knn_topk as knn

    x = _seeded(2, _B, 64)
    return (lambda x: knn(x, x, 8, exclude_self=True)), (x,)


def _build_online_refresh():
    """The online graph refresh's embedding top-k: K8 through
    ``embedding_topk_device``, never a dense (N, N) distance matrix."""
    from repro_torch.online.refresh import embedding_topk_device

    e = _seeded(3, _B, 64)
    return (lambda e: embedding_topk_device(e, 8)), (e,)


def _build_ssl_objective():
    from repro_torch.core.ssl_loss import SSLHyper
    from repro_torch.core.ssl_loss import ssl_objective as objective

    logits, W = _seeded(4, _B, _C), _affinity(5)
    dev = logits.device
    rng = np.random.default_rng(6)
    labels = torch.from_numpy(rng.integers(0, _C, _B, dtype=np.int32)
                              ).to(dev)
    mask = torch.from_numpy((rng.random(_B) < 0.5).astype(np.float32)
                            ).to(dev)
    hyper = SSLHyper(gamma=_GAMMA, kappa=_KAPPA)

    def loss_and_grad(logits, labels, mask, W):
        lg = logits.detach().requires_grad_(True)
        loss = objective(lg, labels, mask, W, hyper, pairwise="fused")[0]
        return loss.detach(), torch.autograd.grad(loss, lg)

    return loss_and_grad, (logits, labels, mask, W)


# ------------------------------------------------------------------ engine
def _tiny_batches(s: int, k: int = 2, p: int = 64, d: int = 16) -> list:
    """``s`` host batches of k workers' concatenated meta-batches."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(s):
        W = rng.random((k, p, p), dtype=np.float32)
        out.append({
            "x": rng.standard_normal((k, p, d), dtype=np.float32),
            "y": rng.integers(0, 5, (k, p), dtype=np.int32),
            "label_mask": (rng.random((k, p)) < 0.5).astype(np.float32),
            "W": (W + W.transpose(0, 2, 1)) / 2,
            "valid": np.ones((k, p), np.float32),
        })
    return out


@contextlib.contextmanager
def _world_group():
    """A world-1 default process group for the entry's lifetime (gloo on
    the CPU, NCCL on the card), unless one is initialised already."""
    import torch.distributed as dist
    if dist.is_initialized():
        yield
        return
    path = tempfile.mkdtemp(prefix="repro_torch_audit-")
    dist.init_process_group("nccl" if device().type == "cuda" else "gloo",
                            init_method=f"file://{path}/store", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
        gc.collect()
        shutil.rmtree(path, ignore_errors=True)


def _build_engine(strategy: str, *, capture: bool = False):
    from repro_torch.api.config import ResilienceConfig
    from repro_torch.core.ssl_loss import SSLHyper
    from repro_torch.models.dnn import DNNConfig, dnn_hidden, init_dnn
    from repro_torch.optim import sgd
    from repro_torch.resilience.guard import guard_init
    from repro_torch.train.engine import Engine, TrainState, data_group
    from repro_torch.train.train_step import dnn_ssl_grads, dnn_ssl_step

    dev = device()
    k = 2
    cfg = DNNConfig(input_dim=16, hidden_dim=32, n_hidden=2, n_classes=5)
    hyper = SSLHyper(gamma=_GAMMA, kappa=_KAPPA)
    opt = sgd()
    dropout = 0.0 if strategy == "async_ps" else 0.1

    def step_fn(s, batch, lr):
        s.params, s.opt_state, metrics = dnn_ssl_step(
            s.params, s.opt_state, batch, cfg=cfg, hyper=hyper, opt=opt,
            lr=lr, generator=s.generator, dropout=dropout, pairwise="auto")
        s.step += 1
        return metrics

    def grad_fn(p, batch, generator=None, workers=None):
        return dnn_ssl_grads(p, batch, cfg=cfg, hyper=hyper,
                             generator=generator,
                             dropout=dropout if generator is not None
                             else 0.0, pairwise="auto", workers=workers)

    mesh = None
    if strategy == "sync_mesh":
        mesh = data_group(k, dev)
        declare_group(mesh, DATA_GROUP)
    engine = Engine(
        step_fn, device=dev, grad_fn=grad_fn, opt=opt, strategy=strategy,
        mesh=mesh, n_workers=k, scan_chunk=CHUNK_STEPS, prefetch=0,
        resilience=ResilienceConfig(nonfinite_guard=True, guard_window=1),
        capture_fn=(lambda p, b: dnn_hidden(p, b["x"].reshape(
            -1, cfg.input_dim))) if capture else None)
    engine.step_scope = step
    params = init_dnn(cfg, 0, device=dev)
    state = TrainState(params=params, opt_state=opt.init(params),
                       generator=torch.Generator(dev).manual_seed(1))
    carry = engine.strategy.init_carry(engine.strategy.place_state(state))
    batches = [engine.strategy.place_batch(b)
               for b in _tiny_batches(CHUNK_STEPS, k)]

    def chunk(carry, batches, lr):
        metrics, guard = engine._guarded_steps(
            carry, iter(batches), lr, capture, guard_init(dev), 0)
        return metrics, guard

    chunk.chunk_steps, chunk.engine = CHUNK_STEPS, engine
    return chunk, (carry, batches, 0.1)


# ------------------------------------------------------------------- serve
def _build_serve_decode():
    """``serve/decode.generate`` under sampling (temperature > 0).

    The surface the reference's prefill key-reuse bug lived on: the R-pass
    proves the contract on every run — prefill (repeated decode) draws
    nothing, the decode loop draws once a step, each from a fresh
    generator state.  Sampling must be on: at temperature 0 the argmax path
    draws nothing and the contract would hold vacuously.
    """
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.serve.decode import generate

    dev = device()
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = tree_map(lambda t: t.to(dev), tf.init_params(
        cfg, torch.Generator().manual_seed(0)))
    prompt = torch.zeros(1, 3, dtype=torch.int32, device=dev)

    def run(params, prompt):
        return generate(params, cfg, prompt, steps=3, cache_len=16,
                        temperature=0.7)

    return run, (params, prompt)


# ----------------------------------------------------------------- entries
graph_reg_fused = EntryPoint(
    name="graph_reg_fused", build=_build_fused,
    B=_B, expect_bxb=0)

graph_reg_blocksparse = EntryPoint(
    name="graph_reg_blocksparse", build=_build_blocksparse,
    B=_B, expect_bxb=0)

graph_reg_ref = EntryPoint(
    name="graph_reg_ref", build=_build_ref,
    B=_B, expect_bxb=None, canary_min_bxb=3)

knn_topk = EntryPoint(
    name="knn_topk", build=_build_knn,
    B=_B, expect_bxb=0)

online_refresh = EntryPoint(
    name="online_refresh", build=_build_online_refresh,
    B=_B, expect_bxb=0)

ssl_objective = EntryPoint(
    name="ssl_objective", build=_build_ssl_objective,
    B=_B, expect_bxb=0)

engine_sequential = EntryPoint(
    name="engine_sequential",
    build=lambda: _build_engine("sequential"), donate=0)

# sync_mesh gathers gradients and metrics with one all_gather a step on
# purpose: every rank sums the R buffers in rank order, which keeps the
# sequential run's summation order (bit for bit at R = 1).
# audit: safe(S002@engine_sync_mesh): rank-ordered sum, bit-equal to sequential
engine_sync_mesh = EntryPoint(
    name="engine_sync_mesh",
    build=lambda: _build_engine("sync_mesh"), donate=0,
    mesh_axes=(DATA_GROUP,), context=_world_group)

engine_async_ps = EntryPoint(
    name="engine_async_ps",
    build=lambda: _build_engine("async_ps"), donate=0)

engine_capture = EntryPoint(
    name="engine_capture",
    build=lambda: _build_engine("sequential", capture=True), donate=0)

serve_decode_generate = EntryPoint(
    name="serve_decode_generate",
    build=_build_serve_decode)

#: Audit order (kernel entries first, engine entries last).
ENTRY_POINTS = (
    graph_reg_fused,
    graph_reg_blocksparse,
    graph_reg_ref,
    knn_topk,
    online_refresh,
    ssl_objective,
    engine_sequential,
    engine_sync_mesh,
    engine_async_ps,
    engine_capture,
    serve_decode_generate,
)
