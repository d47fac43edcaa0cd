"""Train / prefill / serve steps and the analytic model FLOPs (the JAX
package's ``launch/steps.py``).

The steps are plain functions over real tensors: PyTorch runs eagerly,
so there is no jit.  ``input_specs`` gives the step's data inputs as
``meta`` tensors (shapes and dtypes, no storage), the reference's
ShapeDtypeStructs; ``abstract_params``, ``abstract_opt_state`` and
``abstract_decode_state`` give the model, its optimizer state and its
decode state the same way, allocating nothing (the dry run reads
them, ``launch/dryrun.py``).
``make_serve_loop`` is a Python loop of greedy decode steps.

``make_train_step``'s step writes the parameters and the optimizer
state IN PLACE, leaf by leaf (a large leaf ``UPDATE_CHUNK`` elements
at a time), and returns them: a full-width f32 model with its AdamW
moments is 24-51 GB, and the reference's functional update would hold
a second copy of all of it.  The arithmetic of each element is the
reference's (``optim``'s ``update`` and ``apply_updates``).
"""

from __future__ import annotations

import gc
import sys
from typing import Optional

import torch

from repro_torch.config.base import InputShape, ModelConfig, TrainConfig
from repro_torch.models.transformer import (decode_step, forward,
                                            init_decode_state, init_model,
                                            lm_head, lm_loss)
from repro_torch.optim import global_norm, make_optimizer
from repro_torch.optim.optimizer import apply_updates
from repro_torch.tree import tree_flatten, tree_unflatten

# window used when a full-attention dense arch runs long_500k as its
# sliding-window variant
SWA_OVERRIDE_WINDOW = 8192


def _dtype(tcfg: TrainConfig):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[tcfg.dtype]


def swa_window_for(cfg: ModelConfig, shape: InputShape,
                   enabled: bool = True) -> int:
    """-1 = arch default; explicit SWA window for long_500k on every arch
    whose native attention is quadratic / unbounded-cache (dense, vlm,
    and full-attention MoE like arctic).  ``enabled=False`` reproduces the
    pre-hillclimb baseline (dense/vlm only)."""
    if shape.name != "long_500k" or cfg.subquadratic or cfg.family == "ssm":
        return -1
    if enabled or cfg.family in ("dense", "vlm"):
        return SWA_OVERRIDE_WINDOW
    return -1


def input_specs(cfg: ModelConfig, shape: InputShape,
                tcfg: TrainConfig = TrainConfig()):
    """Stand-ins for the step's data inputs: ``meta`` tensors of the
    reference's shapes and dtypes.  Token ids (B,S), or (B,1) for a
    decode step; the audio family's frames (B,S,d_model) in the step's
    dtype, with per-frame ``labels`` (B,S) for training.  An
    encoder-only config has no decode step: ``ValueError``."""
    b, s = shape.global_batch, shape.seq_len

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "decode":
        if cfg.is_encoder_only:
            raise ValueError(f"{cfg.arch_id}: encoder-only, no decode step")
        return {"tokens": spec((b, 1), torch.int32)}
    if cfg.family == "audio":
        out = {"frames": spec((b, s, cfg.d_model), _dtype(tcfg))}
        if shape.kind == "train":
            out["labels"] = spec((b, s), torch.int32)
        return out
    return {"tokens": spec((b, s), torch.int32)}


def abstract_params(cfg: ModelConfig, tcfg: TrainConfig = TrainConfig()):
    """The model's parameters as ``meta`` tensors: the reference's
    shapes and dtypes leaf for leaf, nothing allocated or drawn."""
    return init_model(cfg, torch.Generator(), dtype=_dtype(tcfg),
                      device="meta")


def abstract_opt_state(cfg: ModelConfig, tcfg: TrainConfig = TrainConfig()):
    """The optimizer's ``init`` over ``abstract_params`` (AdamW: ``m``
    and ``v`` like the parameters, the step ``t``), all ``meta``."""
    opt = make_optimizer(tcfg.optimizer, weight_decay=tcfg.weight_decay)
    return opt.init(abstract_params(cfg, tcfg))


def abstract_decode_state(cfg: ModelConfig, shape: InputShape,
                          tcfg: TrainConfig = TrainConfig()):
    """``init_decode_state`` for ``shape`` on ``meta``.  The position
    counter, a host int in the port's decode state, is a 0-d int32
    ``meta`` tensor here, as the reference's is."""
    w = swa_window_for(cfg, shape, enabled=tcfg.long_ctx_swa)
    state = init_decode_state(cfg, shape.global_batch, shape.seq_len,
                              dtype=_dtype(tcfg), window=w, device="meta")
    state["pos"] = torch.empty((), dtype=torch.int32, device="meta")
    return state


def ready_checkpoint() -> None:
    """Import what ``torch.utils.checkpoint`` imports at its first call
    (``torch._dynamo``; seconds on a CUDA build), and collect the
    reference cycles that import leaves: they hold the frames on the
    stack during it, so done inside a step they would keep that step's
    locals -- a full-width model's gradients -- alive until the cyclic
    garbage collector ran.  The train entry points call this before
    they make a model."""
    if "torch._dynamo" not in sys.modules:
        import torch._dynamo  # noqa: F401
        gc.collect()


def loss_and_grads(loss_fn, params):
    """``jax.value_and_grad(loss_fn, has_aux=True)`` over a parameter
    tree: (loss, aux, grads), grads a tree of ``params``' structure.  A
    leaf the loss does not use (an encoder's token embedding: frames
    enter in its place) has a zero gradient, as under JAX."""
    leaves, treedef = tree_flatten(params)
    leaves = [l.detach().requires_grad_(True) for l in leaves]
    loss, aux = loss_fn(tree_unflatten(treedef, leaves))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), aux.detach(), tree_unflatten(treedef,
                                                       list(grads))


# Elements of a leaf that one optimizer call updates: the update's
# elementwise temporaries (about a dozen for AdamW) are each at most this
# long, whatever the leaf's size.  At mixtral-8x7b's width one stacked
# expert leaf is 3.76 GB a layer, and a dozen temporaries of it would
# not fit beside the model's 16 B a parameter.
UPDATE_CHUNK = 1 << 26


def _pieces(leaves, n: int):
    """The leaves (same shape) as aligned flat views of ``n`` elements
    (the last shorter); each leaf whole when it is no longer than ``n``
    or one of the leaves written back (all but the first, the gradient)
    is not contiguous."""
    if leaves[0].numel() <= n or not all(t.is_contiguous()
                                         for t in leaves[1:]):
        return [tuple(leaves)]
    return list(zip(*(t.reshape(-1).split(n) for t in leaves)))


def update_in_place(opt, params, opt_state, grads, lr, grad_scale=None):
    """``opt.update`` then ``apply_updates``, one leaf at a time and a
    leaf ``UPDATE_CHUNK`` elements at a time, each result written into the
    leaf of ``params`` and ``opt_state`` it replaces: the optimizer's
    per-element arithmetic with one piece's temporaries alive at a
    time.  Works for any state whose leaves other than the step count
    ``t`` mirror ``params`` (sgd, momentum, adam, adamw).
    ``grad_scale``: each gradient first becomes ``(g.float() *
    grad_scale).to(g.dtype)``, ``clip_by_global_norm``'s arithmetic.
    Every operation is elementwise, so the pieces give the bits of the
    whole leaf.  Returns (params, opt_state)."""
    p_leaves, treedef = tree_flatten(params)
    g_leaves = tree_flatten(grads)[0]

    def scaled(g):
        if grad_scale is None:
            return g
        return (g.float() * grad_scale).to(g.dtype)

    if isinstance(opt_state, dict) and "t" in opt_state:      # adam(w)
        m_leaves = tree_flatten(opt_state["m"])[0]
        v_leaves = tree_flatten(opt_state["v"])[0]
        t = opt_state["t"]
        for leaf in zip(g_leaves, p_leaves, m_leaves, v_leaves):
            for g, p, m, v in _pieces(leaf, UPDATE_CHUNK):
                ups, new = opt.update({"x": scaled(g)},
                                      {"m": {"x": m}, "v": {"x": v},
                                       "t": t}, {"x": p}, lr)
                p.copy_(apply_updates({"x": p}, ups)["x"])
                m.copy_(new["m"]["x"])
                v.copy_(new["v"]["x"])
        t.add_(1)
        return params, opt_state
    state_leaves = tree_flatten(opt_state)[0]
    for i, (g_leaf, p_leaf) in enumerate(zip(g_leaves, p_leaves)):
        leaf = (g_leaf, p_leaf) + ((state_leaves[i],) if state_leaves
                                   else ())
        for g, p, *st in _pieces(leaf, UPDATE_CHUNK):
            sub = {"x": st[0]} if st else ()
            ups, new = opt.update({"x": scaled(g)}, sub, {"x": p}, lr)
            p.copy_(apply_updates({"x": p}, ups)["x"])
            if st:
                st[0].copy_(new["x"])
    return params, opt_state


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig = TrainConfig(),
                    lr: Optional[float] = None):
    """(train_step, opt): ``train_step(params, opt_state, batch) ->
    (params, opt_state, metrics)``, the gradient of ``lm_loss``
    clipped to ``tcfg.grad_clip`` global norm, then one optimizer
    update.  ``params`` and ``opt_state`` are updated in place and
    returned; ``metrics`` holds ``loss``, ``aux`` and ``grad_norm``
    (0-d tensors on the device, no host sync)."""
    ready_checkpoint()
    opt = make_optimizer(tcfg.optimizer, weight_decay=tcfg.weight_decay)
    lr = tcfg.lr if lr is None else lr
    moe_group = tcfg.moe_group_tokens

    def train_step(params, opt_state, batch):
        def loss_fn(p):
            return lm_loss(cfg, p, batch, chunk_q=tcfg.attn_chunk_q,
                           chunk_kv=tcfg.attn_chunk_kv,
                           moe_group=moe_group, remat=tcfg.remat,
                           context_parallel=tcfg.context_parallel,
                           seq_parallel=tcfg.seq_parallel,
                           remat_policy=tcfg.remat_policy)
        loss, aux, grads = loss_and_grads(loss_fn, params)
        with torch.no_grad():
            scale = None
            if tcfg.grad_clip:
                # clip_by_global_norm, its scale applied leaf by leaf
                gnorm = global_norm(grads)
                scale = torch.clamp(
                    tcfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
            else:
                gnorm = torch.zeros((), device=loss.device)
            params, opt_state = update_in_place(opt, params, opt_state,
                                                grads, lr, scale)
        metrics = {"loss": loss, "aux": aux, "grad_norm": gnorm}
        return params, opt_state, metrics

    return train_step, opt


def make_prefill_step(cfg: ModelConfig, tcfg: TrainConfig = TrainConfig()):
    """Forward over the full prompt; returns last-position logits only
    (the (B,S,V) tensor is never formed)."""

    def prefill_step(params, batch):
        hidden, _ = forward(cfg, params, batch, chunk_q=tcfg.attn_chunk_q,
                            chunk_kv=tcfg.attn_chunk_kv,
                            moe_group=tcfg.moe_group_tokens,
                            return_hidden=True,
                            context_parallel=tcfg.context_parallel,
                            seq_parallel=tcfg.seq_parallel)
        return hidden[:, -1] @ lm_head(params)

    return prefill_step


def make_serve_step(cfg: ModelConfig, shape: InputShape,
                    tcfg: TrainConfig = TrainConfig()):
    """One decode step: next-token logits + updated cache state (the
    caches are written in place; see ``models.decode_step``)."""
    w = swa_window_for(cfg, shape, enabled=tcfg.long_ctx_swa)

    def serve_step(params, state, batch):
        return decode_step(cfg, params, state, batch["tokens"], window=w)

    return serve_step


def make_serve_loop(cfg: ModelConfig, shape: InputShape,
                    tcfg: TrainConfig = TrainConfig(), n_steps: int = 16):
    """N greedy decode steps.  Returns (logits (n_steps, B, V), state);
    the next token stays on the device (no host sync in the loop)."""
    w = swa_window_for(cfg, shape, enabled=tcfg.long_ctx_swa)

    def serve_loop(params, state, batch):
        tok, all_logits = batch["tokens"], []
        for _ in range(n_steps):
            logits, state = decode_step(cfg, params, state, tok, window=w)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            all_logits.append(logits[:, -1])
        return torch.stack(all_logits), state

    return serve_loop


# ---------------------------------------------------------------------------
# Analytic model FLOPs (roofline "useful compute" reference)
# ---------------------------------------------------------------------------

def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """6*N*D for training (3x fwd matmul flops), 2*N_active*D for
    inference; attention O(S^2) term added for quadratic-attention archs."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.tokens
        base = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.tokens
        base = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        base = 2.0 * n_active * tokens
    # attention score/value flops
    if cfg.family not in ("ssm",) and cfg.n_heads:
        s = shape.seq_len
        w = cfg.sliding_window or (SWA_OVERRIDE_WINDOW
                                   if shape.name == "long_500k" else 0)
        ctx = min(s, w) if w else s
        if shape.kind == "decode":
            att = 4.0 * shape.global_batch * ctx * cfg.q_dim
        else:
            per_tok = ctx if w else s / 2  # causal half
            att = 4.0 * shape.tokens * per_tok * cfg.q_dim
            if shape.kind == "train":
                att *= 3.0
        base += att * cfg.num_layers
    return base
