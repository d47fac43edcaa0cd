"""Prefill / serve steps and the analytic model FLOPs (the JAX
package's ``launch/steps.py``, serving half).

The steps are plain functions over real tensors: PyTorch runs eagerly,
so there is no jit and no abstract (ShapeDtypeStruct) form.
``make_serve_loop`` is a Python loop of greedy decode steps.
"""

from __future__ import annotations

import torch

from repro_torch.config.base import InputShape, ModelConfig, TrainConfig
from repro_torch.models.transformer import decode_step, forward, lm_head

# window used when a full-attention dense arch runs long_500k as its
# sliding-window variant
SWA_OVERRIDE_WINDOW = 8192


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
