"""Model assembly: init / forward / decode for the dense, VLM, hybrid,
MoE, xLSTM and audio families (the JAX package's
``models/transformer.py``).

Parameters are plain dicts with the reference's key names; the blocks
are stacked (leading L axis), so ``bridge.from_reference`` carries a
JAX parameter tree across unchanged.  The reference's ``lax.scan`` over
layers is a Python loop over ``blocks[...][l]`` views, and its
``jax.checkpoint`` (``remat``) is ``torch.utils.checkpoint``
(non-reentrant) around each block.  ``lm_loss`` is the reference's
sequence-chunked cross entropy.  Decode carries
per-layer caches, stacked the same way, and writes them IN PLACE (the
KV ring cache of a full-width model is hundreds of MB); the position
counter is a host int.

Families:
  dense / vlm : GQA + RoPE + (SwiGLU | squared-ReLU | GeLU) MLP, optional SWA
  moe         : GQA + top-k MoE FFN (sort-based capacity dispatch,
                ``models/moe.py``)
  hybrid      : parallel attention + Mamba heads per layer (Hymba)
  ssm         : mLSTM / sLSTM pairs (xLSTM, ``models/xlstm.py``): each
                stacked block is one (mLSTM, sLSTM, GeLU MLP) triple, so
                ``num_layers // 2`` blocks (``_n_stack``); as in the
                reference, ``slstm_every`` does not enter the forward
  audio       : the dense block over frame embeddings (HuBERT): an
                encoder (``causal=False``) whose ``batch["frames"]``
                (B,S,d_model) enter in place of embedded tokens; its
                loss takes per-frame ``labels`` with no shift, and it
                has no decode step
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.config.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.layers import (dense_init, embed_init, init_device,
                                       init_mlp, mlp, rms_norm,
                                       take_embedding)
from repro_torch.models.rope import apply_rope
from repro_torch.sharding.hints import hint
from repro_torch.tree import tree_map, tree_stack

FAMILIES = ("dense", "vlm", "hybrid", "moe", "ssm", "audio")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.arch_id}: family {cfg.family!r} is not a "
                         "language model")


# ---------------------------------------------------------------------------
# Block init
# ---------------------------------------------------------------------------

def _init_attn(gen, cfg: ModelConfig, dtype, device=None):
    return {
        "wq": dense_init(gen, (cfg.d_model, cfg.q_dim), dtype=dtype,
                         device=device),
        "wk": dense_init(gen, (cfg.d_model, cfg.kv_dim), dtype=dtype,
                         device=device),
        "wv": dense_init(gen, (cfg.d_model, cfg.kv_dim), dtype=dtype,
                         device=device),
        "wo": dense_init(gen, (cfg.q_dim, cfg.d_model), dtype=dtype,
                         device=device),
    }


def _init_block(gen, cfg: ModelConfig, dtype, device=None):
    dev = init_device(gen, device)
    if cfg.family == "ssm":  # xLSTM pair
        return {
            "ln1": torch.zeros((cfg.d_model,), dtype=torch.float32,
                               device=dev),
            "mlstm": xlstm_lib.init_mlstm(gen, cfg.d_model, cfg.n_heads,
                                          cfg.proj_factor, dtype=dtype,
                                          device=device),
            "ln2": torch.zeros((cfg.d_model,), dtype=torch.float32,
                               device=dev),
            "slstm": xlstm_lib.init_slstm(gen, cfg.d_model, cfg.n_heads,
                                          dtype=dtype, device=device),
            "ln3": torch.zeros((cfg.d_model,), dtype=torch.float32,
                               device=dev),
            "mlp": init_mlp(gen, cfg.d_model, int(cfg.d_model * 4 / 3),
                            "gelu", dtype=dtype, device=device),
        }
    p = {
        "ln1": torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev),
        "attn": _init_attn(gen, cfg, dtype, device=device),
        "ln2": torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev),
    }
    if cfg.family == "moe":
        p["moe"] = moe_lib.init_moe(
            gen, cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.activation,
            dense_residual=cfg.moe_dense_residual,
            dense_ff=cfg.moe_dense_ff, dtype=dtype, device=device)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation,
                            dtype=dtype, device=device)
    if cfg.family == "hybrid":
        p["ssm"] = ssm_lib.init_ssm(gen, cfg.d_model, cfg.ssm_state,
                                    cfg.ssm_expand, cfg.ssm_conv, dtype=dtype,
                                    device=device)
    return p


def init_model(cfg: ModelConfig, gen: torch.Generator,
               dtype=torch.float32, device=None) -> Dict[str, Any]:
    """Random parameters with the reference's keys and stacked shapes.

    Draws from ``gen`` on ``gen``'s device: a CUDA generator
    (``torch.Generator(device="cuda").manual_seed(s)``) draws a
    full-width model on the card (some 2e9 numbers for hymba-1.5b),
    which is how ``chip_smoke.py`` makes its weights; a CPU generator
    draws on the host.  Truncated normals at +-2 with fan-in scale
    (``layers.dense_init``) and the reference's A_log / dt_bias init.
    The numbers are not the JAX package's: parity tests bridge the
    reference's parameters instead (``bridge.from_reference``).
    ``device="meta"`` makes every tensor on ``meta`` and draws nothing
    (``launch.steps.abstract_params``); ``device=None`` is ``gen``'s.
    """
    _check_family(cfg)
    embed = embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype,
                       device=device)
    blocks = tree_stack([_init_block(gen, cfg, dtype, device=device)
                         for _ in range(_n_stack(cfg))])
    params = {
        "embed": embed,
        "blocks": blocks,
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                  device=init_device(gen, device)),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                    dtype=dtype, device=device)
    return params


def _n_stack(cfg: ModelConfig) -> int:
    """Stacked blocks: ``num_layers``, or its pairs for xLSTM."""
    if cfg.family == "ssm":
        if cfg.num_layers % 2:
            raise ValueError(f"{cfg.arch_id}: xLSTM pairs need an even "
                             f"num_layers, not {cfg.num_layers}")
        return cfg.num_layers // 2
    return cfg.num_layers


def _layer(tree, l: int):
    """Layer ``l``'s views of a stacked tree."""
    return tree_map(lambda t: t[l], tree)


def lm_head(params):
    """The output projection: ``head``, or the tied embedding's transpose."""
    head = params.get("head", None)
    return params["embed"].T if head is None else head


# ---------------------------------------------------------------------------
# Block apply (full sequence)
# ---------------------------------------------------------------------------

def _attn_apply(p, cfg: ModelConfig, x, positions, *, window: int,
                chunk_q: int, chunk_kv: int, context_parallel: str = "auto"):
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (x @ p["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = hint(q, "batch", None, "model", None)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attn_lib.attention(q, k, v, causal=cfg.causal, window=window,
                           chunk_q=chunk_q, chunk_kv=chunk_kv,
                           softcap=cfg.attn_logit_softcap,
                           context_parallel=context_parallel)
    o = hint(o, "batch", None, "model", None)
    return o.reshape(b, s, cfg.q_dim) @ p["wo"]


def _block_apply(p, cfg: ModelConfig, x, positions, *, window: int,
                 chunk_q: int, chunk_kv: int, ssm_chunk: int,
                 moe_group: int, context_parallel: str = "auto"):
    """Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        h, _ = xlstm_lib.mlstm_block(p["mlstm"], rms_norm(x, p["ln1"]),
                                     cfg.n_heads, chunk=ssm_chunk)
        x = x + h
        h, _ = xlstm_lib.slstm_block(p["slstm"], rms_norm(x, p["ln2"]),
                                     cfg.n_heads)
        x = x + h
        x = x + mlp(p["mlp"], rms_norm(x, p["ln3"]), "gelu")
        return x, aux
    a_in = rms_norm(x, p["ln1"])
    a_out = _attn_apply(p["attn"], cfg, a_in, positions, window=window,
                        chunk_q=chunk_q, chunk_kv=chunk_kv,
                        context_parallel=context_parallel)
    if cfg.family == "hybrid":
        s_out, _ = ssm_lib.ssm_forward(p["ssm"], a_in, n_state=cfg.ssm_state,
                                       chunk=ssm_chunk)
        a_out = 0.5 * (a_out + s_out)
    x = x + a_out
    m_in = rms_norm(x, p["ln2"])
    if cfg.family == "moe":
        y, aux = moe_lib.moe_ffn(
            p["moe"], m_in, top_k=cfg.top_k, activation=cfg.activation,
            capacity_factor=cfg.moe_capacity_factor, group_size=moe_group,
            dense_residual=cfg.moe_dense_residual)
    else:
        y = mlp(p["mlp"], m_in, cfg.activation)
    return x + y, aux


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

# The matrix products without batch dimensions, whose outputs the
# "dots" policy keeps (``jax.checkpoint_policies.
# dots_with_no_batch_dims_saveable``): ``x @ W`` of a (B,S,d) activation
# and a (d,F) weight is one ``mm`` (or ``addmm``); the attention's
# batched einsums are ``bmm`` and are recomputed.
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def embed_inputs(cfg: ModelConfig, params, batch):
    """Token embeddings, or the audio stub frontend's frames (B,S,d)
    cast to the embedding's dtype."""
    if "frames" in batch:
        return batch["frames"].to(params["embed"].dtype)
    return take_embedding(params["embed"], batch["tokens"])


def forward(cfg: ModelConfig, params, batch, *, window: int = -1,
            chunk_q: int = 512, chunk_kv: int = 1024, ssm_chunk: int = 256,
            moe_group: int = 0, remat: bool = False, return_hidden=False,
            context_parallel: str = "auto", seq_parallel: bool = False,
            remat_policy: str = "full"):
    """Full-sequence forward.  Returns (logits, aux_loss).

    ``window``: -1 => use cfg.sliding_window; 0 => force full attention;
    >0 => override (used for the long_500k SWA variants of dense archs).
    ``seq_parallel`` is the reference's residual-stream hint, a no-op
    without a mesh.  ``remat``: each block under ``torch.utils.
    checkpoint`` (non-reentrant): ``remat_policy="full"`` keeps only the
    block's input and recomputes the rest in the backward; ``"dots"``
    also keeps the outputs of its matrix products (``_dots_policy``).
    Either way the gradients are the same bits as without remat.
    """
    _check_family(cfg)
    x = embed_inputs(cfg, params, batch)
    res_hint = (lambda t: hint(t, "batch", "model", None)) if seq_parallel \
        else (lambda t: hint(t, "batch", None, None))
    x = res_hint(x)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    w = cfg.sliding_window if window < 0 else window
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    block = functools.partial(_block_apply, cfg=cfg, positions=positions,
                              window=w, chunk_q=chunk_q, chunk_kv=chunk_kv,
                              ssm_chunk=ssm_chunk, moe_group=moe_group,
                              context_parallel=context_parallel)
    if remat:
        kw = ({"context_fn": _dots_context} if remat_policy == "dots"
              else {})
        plain_block = block

        def block(p, x):
            return checkpoint(plain_block, p, x=x, use_reentrant=False,
                              **kw)
    for l in range(_n_stack(cfg)):
        x, a = block(_layer(params["blocks"], l), x=x)
        x = res_hint(x)
        aux = aux + a
    x = rms_norm(x, params["final_norm"])
    if return_hidden:
        return x, aux
    return x @ lm_head(params), aux


def _chunk_ce(h, t, head):
    """Sum over a chunk of ``logsumexp(logits) - logits[gold]``, the
    logits (B,c,V) in f32."""
    logits = (h @ head).float()
    logits = hint(logits, "batch", None, "model")
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, t[..., None])[..., 0]
    return torch.sum(lse - gold)


def lm_loss(cfg: ModelConfig, params, batch, *, loss_chunk: int = 512,
            **fwd_kw):
    """Sequence-chunked cross-entropy (never keeps (B,S,V) f32 logits
    for the backward).

    Causal LM: predict token t+1 from t; an encoder (audio): the
    per-frame ``labels``, no shift.  The sequence is cut into chunks
    of ``loss_chunk`` (one chunk when that does not divide it, as in
    the reference); each chunk's logits are recomputed in the
    backward (``torch.utils.checkpoint``, non-reentrant: the
    reference's ``@jax.checkpoint``).  Returns (loss + 0.01 * aux, aux),
    the loss the mean over ``b * s``.
    """
    _check_family(cfg)
    hidden, aux = forward(cfg, params, batch, return_hidden=True, **fwd_kw)
    head = lm_head(params)
    if cfg.is_encoder_only:
        hs, tg = hidden, batch["labels"]
    else:
        tokens = batch["tokens"]
        hs, tg = hidden[:, :-1], tokens[:, 1:]
    b, s, _ = hs.shape
    c = min(loss_chunk, s)
    if s % c:
        c = s
    total = torch.zeros((), dtype=torch.float32, device=hs.device)
    for i in range(s // c):
        sl = slice(i * c, (i + 1) * c)
        total = total + checkpoint(_chunk_ce, hs[:, sl], tg[:, sl], head,
                                   use_reentrant=False)
    loss = total / (b * s)
    return loss + 0.01 * aux, aux


# ---------------------------------------------------------------------------
# Decode (single token with per-layer caches)
# ---------------------------------------------------------------------------

def _layer_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                 device):
    if cfg.family == "ssm":
        return {"m": xlstm_lib.init_mlstm_state(batch, cfg.d_model,
                                                cfg.n_heads, cfg.proj_factor,
                                                dtype=dtype, device=device),
                "s": xlstm_lib.init_slstm_state(batch, cfg.d_model,
                                                device=device)}
    kv_len = cache_len
    if cfg.sliding_window:
        kv_len = min(cache_len, cfg.sliding_window)
    c = {"kv": attn_lib.init_kv_cache(batch, kv_len, cfg.n_kv_heads,
                                      cfg.head_dim, dtype, device)}
    if cfg.family == "hybrid":
        c["ssm"] = ssm_lib.init_ssm_state(batch, cfg.d_model, cfg.ssm_state,
                                          cfg.ssm_expand, cfg.ssm_conv, dtype,
                                          device)
    return c


def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      dtype=torch.bfloat16, window: int = -1, device=None):
    """Stacked per-layer caches + position counter (a host int).
    ``device=None`` is the CUDA device (raises when there is none)."""
    _check_family(cfg)
    device = resolve_device(device)
    w = cfg.sliding_window if window < 0 else window
    if w and w > 0:
        kv_len = min(cache_len, w)
    else:
        kv_len = cache_len
    template = _layer_cache(cfg, batch, kv_len if w else cache_len, dtype,
                            device)
    n_stack = _n_stack(cfg)
    caches = tree_map(
        lambda t: torch.zeros((n_stack,) + tuple(t.shape),
                              dtype=t.dtype, device=device), template)
    caches = _refill_pos(caches)
    return {"layers": caches, "pos": 0}


def _refill_pos(caches):
    """kv position slots start at -1 (invalid) and the mLSTM stabilizer
    at ``NEG``, not 0 -- re-fill them after the zeros-stacking above.

    As in the reference, only a tuple under ``m`` or ``mem`` (the
    mLSTM's (C, n, m)) is re-filled: the sLSTM's stabilizer ``s["m"]``
    is a tensor and stays 0, so decode's first sLSTM step starts from
    ``max(logf, i)``, where ``slstm_scan(state=None)`` starts from
    ``NEG`` (the two differ only through the ``n`` clamp at 1e-6)."""
    if isinstance(caches, dict):
        for k, v in caches.items():
            if k == "pos" and isinstance(v, torch.Tensor):
                v.fill_(-1)
            elif k in ("m", "mem") and isinstance(v, tuple):
                v[2].fill_(xlstm_lib.NEG)
            else:
                _refill_pos(v)
    elif isinstance(caches, tuple):
        for v in caches:
            _refill_pos(v)
    return caches


def _block_decode(p, cfg: ModelConfig, x, cache, pos: int, *, window: int):
    """One layer of one decode step; ``cache`` (this layer's views of the
    stacked caches) is written in place.  Returns (x, cache)."""
    if cfg.family == "ssm":
        h, m_new = xlstm_lib.mlstm_block(p["mlstm"], rms_norm(x, p["ln1"]),
                                         cfg.n_heads, state=cache["m"],
                                         chunk=1)
        x = x + h
        h, s_new = xlstm_lib.slstm_block(p["slstm"], rms_norm(x, p["ln2"]),
                                         cfg.n_heads, state=cache["s"])
        x = x + h
        x = x + mlp(p["mlp"], rms_norm(x, p["ln3"]), "gelu")
        # the new states are fresh tensors: copy them into the views
        for old, new in zip(cache["m"]["mem"], m_new["mem"]):
            old.copy_(new)
        cache["m"]["conv"].copy_(m_new["conv"])
        for k in ("c", "n", "m", "h"):
            cache["s"][k].copy_(s_new[k])
        return x, cache
    b = x.shape[0]
    a_in = rms_norm(x, p["ln1"])
    pa = p["attn"]
    q = (a_in @ pa["wq"]).reshape(b, 1, cfg.n_heads, cfg.head_dim)
    k = (a_in @ pa["wk"]).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
    v = (a_in @ pa["wv"]).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
    posb = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)
    kv = attn_lib.update_kv_cache(cache["kv"], k, v, pos)
    o = attn_lib.decode_attention(q, kv, pos, window=window,
                                  softcap=cfg.attn_logit_softcap)
    a_out = o.reshape(b, 1, cfg.q_dim) @ pa["wo"]
    if cfg.family == "hybrid":
        s_out, ssm_new = ssm_lib.ssm_decode_step(
            p["ssm"], a_in, cache["ssm"], n_state=cfg.ssm_state)
        a_out = 0.5 * (a_out + s_out)
        cache["ssm"]["h"].copy_(ssm_new["h"])
        cache["ssm"]["conv"].copy_(ssm_new["conv"])
    x = x + a_out
    m_in = rms_norm(x, p["ln2"])
    if cfg.family == "moe":
        # no group: each decode token is its own group, as the reference
        y, _ = moe_lib.moe_ffn(
            p["moe"], m_in, top_k=cfg.top_k, activation=cfg.activation,
            capacity_factor=cfg.moe_capacity_factor,
            dense_residual=cfg.moe_dense_residual)
    else:
        y = mlp(p["mlp"], m_in, cfg.activation)
    return x + y, cache


def decode_step(cfg: ModelConfig, params, state, tokens, *, window: int = -1):
    """One decode step.  tokens (B,1) int.

    Returns (logits (B,1,V), state).  ``state`` is advanced in place,
    caches and ``pos`` alike, and returned: there is one decode state,
    never an older copy whose ``pos`` disagrees with its caches.
    An encoder-only config raises ``ValueError``.
    """
    _check_family(cfg)
    if cfg.is_encoder_only:
        raise ValueError(f"{cfg.arch_id} is encoder-only: no decode step")
    w = cfg.sliding_window if window < 0 else window
    x = take_embedding(params["embed"], tokens)
    pos = state["pos"]
    for l in range(_n_stack(cfg)):
        x, _ = _block_decode(_layer(params["blocks"], l), cfg, x,
                             _layer(state["layers"], l), pos, window=w)
    x = rms_norm(x, params["final_norm"])
    logits = x @ lm_head(params)
    state["pos"] = pos + 1
    return logits, state
