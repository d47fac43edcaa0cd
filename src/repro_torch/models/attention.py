"""GQA attention: naive, flash-style chunked, banded sliding-window, decode.

Layout: q (B,S,H,D); k/v (B,T,Hkv,D).  The JAX package's
``models/attention.py`` repeats k/v to the full H heads before the
scores; here ``attention()`` keeps the same dispatch, and

  * ``naive_attention``   — O(S*T) materialized scores; small shapes
    (``s*t <= 256*256``) and chunk sizes that do not divide; takes
    head-expanded k/v, as the reference's does;
  * ``chunked_attention`` — flash-style online softmax over Q and KV
    chunks (the full causal/window mask);
  * ``banded_attention``  — O(S*W) sliding window: each Q chunk sees only
    the KV chunks inside its band;

take k/v with Hkv heads (any Hkv dividing H; Hkv == H is the head-
expanded case).  On the CPU they repeat k/v and run the reference's
algorithm in plain PyTorch.  On a CUDA tensor both are one launch of the
hand-written attention kernel (``kernels/ops.py: gqa_flash_attention``)
on the un-repeated k/v: the kernel computes the same masked softmax,
which is the chunked function exactly and the banded one whenever the
band holds every visible key (always under the causal mask).  The
kernel has no logit softcap, so ``softcap > 0`` on the card raises.

The context-parallel branches (``chunked_attention_cp``,
``banded_attention_cp``) put the Q-CHUNK axis, not the heads, on the
"model" mesh axis: ``attention()`` takes them when the head count does
not divide that axis (``context_parallel="auto"`` under a mesh,
``sharding.hints``) or when asked (``"always"``, with or without a
mesh).  On the CPU they run the reference's algorithm in plain
PyTorch.  On a CUDA tensor shard ``r`` of the ``m = axis_size("model")``
shards owns the contiguous q rows ``[r*S/m, (r+1)*S/m)`` (the
reference's q chunks are contiguous and their axis is hinted onto
"model"), and each shard is one launch of the attention kernel at
``q_offset + r*S/m`` on the un-repeated k/v; the outputs are
concatenated.  A mesh's shards share one physical device (``set_mesh``
admits no other), so they run one after another.

The ring-cache decode (``init_kv_cache``, ``update_kv_cache``,
``decode_attention``) is plain PyTorch, as the reference's is jnp;
``update_kv_cache`` writes the cache IN PLACE (a serving cache is
hundreds of MB at full width) and returns it.

All softmax math is float32; inputs/outputs keep their dtype.
"""

from __future__ import annotations

import math

import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.sharding.hints import axis_size, hint

NEG_INF = -1e30

# head_dim-sharded decode attention for archs whose head count doesn't
# divide the model axis (the reference's perf toggle).  It picks the
# spec of decode's k/v hints (``decode_kv_axes``); ``hint`` places
# nothing on one physical device, so in the port it changes no value
# and no placement until ROADMAP queue 1 item 15
DECODE_HEADDIM_SHARD = True


def repeat_kv(k, n_heads: int):
    """(B,T,Hkv,D) -> (B,T,H,D) by repeating each kv head H/Hkv times."""
    rep = n_heads // k.shape[2]
    if rep == 1:
        return k
    return torch.repeat_interleave(k, rep, dim=2)


def _mask_bias(q_pos, k_pos, causal: bool, window: int):
    """(Sq,Tk) additive f32 bias from absolute positions."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        m &= k_pos[None, :] > q_pos[:, None] - window
    return _bias(m)


def _bias(m):
    zero = torch.zeros((), dtype=torch.float32, device=m.device)
    return torch.where(m, zero, torch.full_like(zero, NEG_INF))


def _softcap(s, softcap: float):
    return torch.tanh(s / softcap) * softcap if softcap > 0 else s


def _scores(q, k):
    """einsum bqhd,bthd->bhqt with f32 products (preferred_element_type)."""
    return torch.einsum("bqhd,bthd->bhqt", q.float(), k.float())


def _pv(p, v):
    """einsum bhqt,bthd->bqhd of p cast to v's dtype, f32 accumulate."""
    return torch.einsum("bhqt,bthd->bqhd", p.to(v.dtype).float(), v.float())


def naive_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    softcap: float = 0.0):
    """q (B,S,H,D); k/v (B,T,H,D) already head-expanded."""
    b, s, h, d = q.shape
    s_ = _scores(q, k) / math.sqrt(d)
    s_ = _softcap(s_, softcap)
    q_pos = torch.arange(s, device=q.device) + q_offset
    k_pos = torch.arange(k.shape[1], device=q.device)
    s_ = s_ + _mask_bias(q_pos, k_pos, causal, window)[None, None]
    p = torch.softmax(s_, dim=-1)
    return _pv(p, v).to(q.dtype)


def _flash_inner(qb, k, v, q_pos, causal, window, chunk_kv, scale, softcap):
    """Online softmax over KV chunks for one Q chunk.

    qb: (B,Sq,H,D) f32; k/v (B,T,H,D).  Returns (B,Sq,H,D) f32.
    """
    b, sq, h, d = qb.shape
    t = k.shape[1]
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=qb.device)
    m_run = torch.full((b, h, sq), NEG_INF, dtype=torch.float32,
                       device=qb.device)
    l_run = torch.zeros((b, h, sq), dtype=torch.float32, device=qb.device)
    for blk in range(t // chunk_kv):
        kb = k[:, blk * chunk_kv:(blk + 1) * chunk_kv]
        vb = v[:, blk * chunk_kv:(blk + 1) * chunk_kv]
        s_ = _scores(qb, kb) * scale
        s_ = _softcap(s_, softcap)
        k_pos = blk * chunk_kv + torch.arange(chunk_kv, device=qb.device)
        s_ = s_ + _mask_bias(q_pos, k_pos, causal, window)[None, None]
        s_ = hint(s_, "batch", "model", None, None)
        m_new = torch.maximum(m_run, s_.amax(dim=-1))
        p = torch.exp(s_ - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqt,bthd->bhqd", p, vb.float())
        acc = acc * corr[..., None] + pv
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return out.movedim(1, 2)                            # (B,Sq,H,D)


def _kernel_route(q, softcap: float) -> bool:
    """True when the call goes to the attention kernel (a CUDA tensor);
    the kernel has no softcap, so that combination raises."""
    if q.device.type != "cuda":
        return False
    if softcap > 0:
        raise NotImplementedError(
            "attention logit softcap > 0 on a CUDA tensor: the attention "
            "kernel (kernels/csrc/flash_attention.cu, K4) has no softcap; "
            "no registered config sets one")
    return True


def chunked_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                      chunk_q=512, chunk_kv=1024, softcap: float = 0.0):
    """q (B,S,H,D); k/v (B,T,Hkv,D), Hkv dividing H."""
    b, s, h, d = q.shape
    t = k.shape[1]
    chunk_q = min(chunk_q, s)
    chunk_kv = min(chunk_kv, t)
    if s % chunk_q or t % chunk_kv:
        raise ValueError(f"seq {s}/{t} not divisible by chunks "
                         f"{chunk_q}/{chunk_kv}")
    if _kernel_route(q, softcap):
        return kernel_ops.gqa_flash_attention(q, k, v, causal=causal,
                                              window=window,
                                              q_offset=q_offset)
    k, v = repeat_kv(k, h), repeat_kv(v, h)
    scale = 1.0 / math.sqrt(d)
    outs = []
    for blk in range(s // chunk_q):
        qb = q[:, blk * chunk_q:(blk + 1) * chunk_q]
        q_pos = q_offset + blk * chunk_q + torch.arange(chunk_q,
                                                        device=q.device)
        outs.append(_flash_inner(qb, k, v, q_pos, causal, window, chunk_kv,
                                 scale, softcap))
    return torch.cat(outs, dim=1).to(q.dtype)


def banded_attention(q, k, v, *, window: int, causal=True, q_offset=0,
                     chunk_q=512, chunk_kv=1024, softcap: float = 0.0):
    """True O(S*W) sliding-window attention via per-chunk KV band gather.
    q (B,S,H,D); k/v (B,T,Hkv,D), Hkv dividing H."""
    b, s, h, d = q.shape
    t = k.shape[1]
    chunk_q = min(chunk_q, s)
    chunk_kv = min(chunk_kv, t)
    if s % chunk_q or t % chunk_kv:
        raise ValueError("seq not divisible by chunks")
    if _kernel_route(q, softcap):
        if not causal:
            # without the causal mask the band cuts off visible keys
            # that the kernel's window mask would keep
            raise NotImplementedError(
                "non-causal banded attention on a CUDA tensor: the "
                "attention kernel computes the full window")
        return kernel_ops.gqa_flash_attention(q, k, v, causal=causal,
                                              window=window,
                                              q_offset=q_offset)
    k, v = repeat_kv(k, h), repeat_kv(v, h)
    # band for q chunk [qs, qs+cq): kv in (qs - window, qs + cq - 1]
    nb = (window - 1 + chunk_q + chunk_kv - 1) // chunk_kv + 1
    nb = min(nb, t // chunk_kv)
    scale = 1.0 / math.sqrt(d)
    outs = []
    for blk in range(s // chunk_q):
        qb = q[:, blk * chunk_q:(blk + 1) * chunk_q]
        q_start = blk * chunk_q
        lo = q_start - (window - 1) + q_offset   # earliest visible kv pos
        first = min(max(lo // chunk_kv, 0), t // chunk_kv - nb)
        kb = k[:, first * chunk_kv:(first + nb) * chunk_kv]
        vb = v[:, first * chunk_kv:(first + nb) * chunk_kv]
        q_pos = q_offset + q_start + torch.arange(chunk_q, device=q.device)
        s_ = _scores(qb, kb) * scale
        s_ = _softcap(s_, softcap)
        k_pos = first * chunk_kv + torch.arange(nb * chunk_kv,
                                                device=q.device)
        m = k_pos[None, :] > q_pos[:, None] - window
        if causal:
            m &= k_pos[None, :] <= q_pos[:, None]
        s_ = s_ + _bias(m)[None, None]
        s_ = hint(s_, "batch", "model", None, None)
        p = torch.softmax(s_, dim=-1)
        outs.append(_pv(p, vb))
    return torch.cat(outs, dim=1).to(q.dtype)


def _cp_kernel(q, k, v, *, causal, window, q_offset):
    """The context-parallel route on the card: one launch of the
    attention kernel per model shard, shard ``r`` of ``m`` on the q rows
    ``[r*S/m, (r+1)*S/m)`` at ``q_offset + r*S/m``, outputs concatenated.

    Gradients go through each launch's ``FlashAttentionFn``: a shard's
    dq is its own launch's, dk and dv are autograd's sum over the
    shards, so their bits differ from those of one launch over all
    rows (the same sum in another order)."""
    m = axis_size("model")
    s = q.shape[1]
    if s % m:
        raise ValueError(f"context-parallel attention: {s} q rows do not "
                         f"split over {m} model shards")
    rows = s // m
    outs = [kernel_ops.gqa_flash_attention(
        q[:, r * rows:(r + 1) * rows], k, v, causal=causal, window=window,
        q_offset=q_offset + r * rows) for r in range(m)]
    return outs[0] if m == 1 else torch.cat(outs, dim=1)


def _cp_chunks(s, t, chunk_q, chunk_kv):
    """The chunk sizes clamped to S and T; they must divide them."""
    chunk_q = min(chunk_q, s)
    chunk_kv = min(chunk_kv, t)
    if s % chunk_q or t % chunk_kv:
        raise ValueError("seq not divisible by chunks")
    return chunk_q, chunk_kv


def chunked_attention_cp(q, k, v, *, causal=True, window=0, q_offset=0,
                         chunk_q=512, chunk_kv=1024, softcap: float = 0.0):
    """Context-parallel flash: the Q-CHUNK axis (not heads) carries the
    "model" mesh axis.  Used when n_heads doesn't divide the model axis
    (phi4 24H, hymba 25H, arctic 56H on a 16-way axis): each shard owns
    S/m of the query rows and streams the (small, GQA) KV blocks.
    q (B,S,H,D); k/v (B,T,Hkv,D), Hkv dividing H.  On the CPU all q
    chunks are one batched axis under an online softmax over KV blocks;
    on the card one kernel launch per model shard (``_cp_kernel``)."""
    b, s, h, d = q.shape
    t = k.shape[1]
    chunk_q, chunk_kv = _cp_chunks(s, t, chunk_q, chunk_kv)
    if _kernel_route(q, softcap):
        return _cp_kernel(q, k, v, causal=causal, window=window,
                          q_offset=q_offset)
    k, v = repeat_kv(k, h), repeat_kv(v, h)
    nc = s // chunk_q
    scale = 1.0 / math.sqrt(d)
    qc = hint(q.reshape(b, nc, chunk_q, h, d),
              "batch", "model", None, None, None).float()
    dev = q.device
    q_pos = (q_offset + torch.arange(nc, device=dev)[:, None] * chunk_q
             + torch.arange(chunk_q, device=dev)[None, :])   # (nc, cq)
    acc = torch.zeros((b, nc, h, chunk_q, d), dtype=torch.float32,
                      device=dev)
    m_run = torch.full((b, nc, h, chunk_q), NEG_INF, dtype=torch.float32,
                       device=dev)
    l_run = torch.zeros((b, nc, h, chunk_q), dtype=torch.float32,
                        device=dev)
    for blk in range(t // chunk_kv):
        kb = k[:, blk * chunk_kv:(blk + 1) * chunk_kv]
        vb = v[:, blk * chunk_kv:(blk + 1) * chunk_kv]
        s_ = torch.einsum("bnqhd,bthd->bnhqt", qc, kb.float()) * scale
        s_ = _softcap(s_, softcap)
        k_pos = blk * chunk_kv + torch.arange(chunk_kv, device=dev)
        m = torch.ones((nc, chunk_q, chunk_kv), dtype=torch.bool,
                       device=dev)
        if causal:
            m &= k_pos[None, None, :] <= q_pos[..., None]
        if window > 0:
            m &= k_pos[None, None, :] > q_pos[..., None] - window
        s_ = s_ + _bias(m)[:, None][None]
        s_ = hint(s_, "batch", "model", None, None, None)
        m_new = torch.maximum(m_run, s_.amax(dim=-1))
        p = torch.exp(s_ - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(dim=-1)
        pv = torch.einsum("bnhqt,bthd->bnhqd", p, vb.float())
        acc = acc * corr[..., None] + pv
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]   # (B,nc,H,cq,D)
    return out.movedim(3, 2).reshape(b, s, h, d).to(q.dtype)


def banded_attention_cp(q, k, v, *, window: int, causal=True, q_offset=0,
                        chunk_q=512, chunk_kv=1024, softcap: float = 0.0):
    """Context-parallel sliding window: all q chunks processed as a
    batched (shardable) axis; each chunk gathers its own KV band.  Used
    when heads don't divide the model axis (hymba 25H).  q (B,S,H,D);
    k/v (B,T,Hkv,D).  On the card one kernel launch per model shard
    (``_cp_kernel``), which computes the full window: the band holds
    every visible key under the causal mask, so non-causal raises there,
    as ``banded_attention`` does."""
    b, s, h, d = q.shape
    t = k.shape[1]
    chunk_q, chunk_kv = _cp_chunks(s, t, chunk_q, chunk_kv)
    if _kernel_route(q, softcap):
        if not causal:
            raise NotImplementedError(
                "non-causal banded attention on a CUDA tensor: the "
                "attention kernel computes the full window")
        return _cp_kernel(q, k, v, causal=causal, window=window,
                          q_offset=q_offset)
    k, v = repeat_kv(k, h), repeat_kv(v, h)
    nc = s // chunk_q
    nb = (window - 1 + chunk_q + chunk_kv - 1) // chunk_kv + 1
    nb = min(nb, t // chunk_kv)
    scale = 1.0 / math.sqrt(d)
    qc = hint(q.reshape(b, nc, chunk_q, h, d),
              "batch", "model", None, None, None)
    dev = q.device
    q_starts = torch.arange(nc, device=dev) * chunk_q
    lo = q_starts - (window - 1) + q_offset
    first = torch.clamp(torch.div(lo, chunk_kv, rounding_mode="floor"),
                        0, t // chunk_kv - nb)                  # (nc,)
    k_pos = (first[:, None] * chunk_kv
             + torch.arange(nb * chunk_kv, device=dev)[None])   # (nc, nbk)
    kbs, vbs = k[:, k_pos], v[:, k_pos]                 # (B,nc,nbk,H,D)
    s_ = torch.einsum("bnqhd,bnthd->bnhqt", qc.float(), kbs.float()) * scale
    s_ = _softcap(s_, softcap)
    q_pos = q_offset + q_starts[:, None] + torch.arange(chunk_q,
                                                        device=dev)[None]
    m = k_pos[:, None, :] > q_pos[..., None] - window
    if causal:
        m &= k_pos[:, None, :] <= q_pos[..., None]
    s_ = s_ + _bias(m)[None, :, None]
    s_ = hint(s_, "batch", "model", None, None, None)
    p = torch.softmax(s_, dim=-1)
    o = torch.einsum("bnhqt,bnthd->bnqhd", p.to(vbs.dtype).float(),
                     vbs.float())
    return o.reshape(b, s, h, d).to(q.dtype)


def attention(q, k, v, *, causal=True, window=0, q_offset=0,
              chunk_q=512, chunk_kv=1024, softcap: float = 0.0,
              context_parallel: str = "auto"):
    """Dispatch, as the reference's.  k/v are (B,T,Hkv,D); the naive
    branch takes them head-expanded, the others as they are.

    context_parallel: "auto" = shard q chunks over "model" when the head
    count doesn't divide the model axis (never, with no mesh); "never" |
    "always" override.
    """
    h = q.shape[2]
    s, t = q.shape[1], k.shape[1]
    if s * t <= 256 * 256 or s % min(chunk_q, s) or t % min(chunk_kv, t):
        return naive_attention(q, repeat_kv(k, h), repeat_kv(v, h),
                               causal=causal, window=window,
                               q_offset=q_offset, softcap=softcap)
    msize = axis_size("model")
    want_cp = (context_parallel == "always" or
               (context_parallel == "auto" and msize > 1 and h % msize))
    if want_cp:
        # q-chunk count must be a multiple of the model axis: shrink
        # chunk_q if needed (train_4k: 4096/512 = 8 chunks < 16 shards)
        cq = min(chunk_q, s)
        if (s // cq) % msize and s % msize == 0:
            cq = max(s // msize, 1)
        if (s // cq) % msize == 0:
            if window and window < t:
                # banded CP gathers ~(window/chunk_q)x duplicated KV per
                # chunk: the reference takes it only when chunk_q >=
                # window, or when asked
                if cq >= window or context_parallel == "always":
                    return banded_attention_cp(
                        q, k, v, window=window, causal=causal,
                        q_offset=q_offset, chunk_q=cq, chunk_kv=chunk_kv,
                        softcap=softcap)
            else:
                return chunked_attention_cp(
                    q, k, v, causal=causal, window=window,
                    q_offset=q_offset, chunk_q=cq, chunk_kv=chunk_kv,
                    softcap=softcap)
    if window and window < t:
        return banded_attention(q, k, v, window=window, causal=causal,
                                q_offset=q_offset, chunk_q=chunk_q,
                                chunk_kv=chunk_kv, softcap=softcap)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, chunk_q=chunk_q,
                             chunk_kv=chunk_kv, softcap=softcap)


# ---------------------------------------------------------------------------
# Decode (single token, ring-buffer KV cache)
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, cache_len: int, n_kv: int, head_dim: int,
                  dtype=torch.bfloat16, device=None):
    """The ring cache on ``device`` (``resolve_device``: ``cuda`` unless
    ``"cpu"`` is passed)."""
    device = resolve_device(device)
    return {
        "k": torch.zeros((batch, cache_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, cache_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        # absolute position per slot
        "pos": torch.full((cache_len,), -1, dtype=torch.int32,
                          device=device),
    }


def update_kv_cache(cache, k_new, v_new, pos: int):
    """k_new/v_new (B,1,Hkv,D); pos the absolute position (a host int).
    Writes slot ``pos % W`` of ``cache`` in place and returns it."""
    slot = pos % cache["k"].shape[1]
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    cache["pos"][slot] = pos
    return cache


def decode_kv_axes(h: int, d: int):
    """The hint axes of decode's head-expanded k/v (B,W,H,D), the
    reference's two branches: heads over "model" when they divide it;
    otherwise, with ``DECODE_HEADDIM_SHARD``, head_dim over "model"."""
    msize = axis_size("model")
    if DECODE_HEADDIM_SHARD and msize > 1 and h % msize and d % msize == 0:
        return ("batch", None, None, "model")
    return ("batch", None, "model", None)


def decode_attention(q, cache, pos: int, *, window=0, softcap: float = 0.0):
    """q (B,1,H,D) against the ring cache; returns (B,1,H,D).  k/v take
    the hints of ``decode_kv_axes``, which place and never change a
    value."""
    b, _, h, d = q.shape
    axes = decode_kv_axes(h, d)
    k = hint(repeat_kv(cache["k"], h), *axes)
    v = hint(repeat_kv(cache["v"], h), *axes)
    s_ = _scores(q, k) / math.sqrt(d)
    s_ = _softcap(s_, softcap)
    kp = cache["pos"]
    valid = (kp >= 0) & (kp <= pos)
    if window > 0:
        valid &= kp > pos - window
    s_ = s_ + _bias(valid)[None, None, None, :]
    p = torch.softmax(s_, dim=-1)
    return _pv(p, v).to(q.dtype)
