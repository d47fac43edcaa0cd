"""xLSTM blocks: chunkwise-parallel mLSTM + sequential sLSTM
[arXiv:2405.04517], the JAX package's ``models/xlstm.py``.

mLSTM: matrix-memory LSTM with exponential gating.  Training/prefill uses
the chunkwise form -- intra-chunk quadratic (attention-like, (B,H,Q,Q)),
inter-chunk recurrent state (C (B,H,Dh,Dh), n (B,H,Dh), stabilizer m
(B,H)) carried across chunks; the reference's ``lax.scan`` over chunks
is a Python loop.  All gate math is stabilized in log space, in f32
whatever the model dtype.

sLSTM: scalar-memory LSTM with exponential gating and block-diagonal
recurrent weights (per head) -- inherently sequential: the reference's
``lax.scan`` over time is a Python loop of one step a token (one
``bhd,hde`` product and the gate arithmetic, eager PyTorch ops).

No kernel of the port runs here: the reference computes both cells in
jnp, outside any Pallas kernel.  Every cast sits where the reference
puts it, so bf16 serving rounds where the reference rounds.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.models.ssm import _causal_conv
from repro_torch.sharding.hints import hint

NEG = -1e30


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _inner_width(d_model: int, n_heads: int, proj_factor: float) -> int:
    di = int(proj_factor * d_model)
    return di - di % n_heads


def init_mlstm(gen: torch.Generator, d_model: int, n_heads: int,
               proj_factor: float = 2.0, conv_k: int = 4,
               dtype=torch.float32):
    """The reference's keys and shapes (the gate weights and biases in
    f32), drawn from ``gen`` on its device in the reference's key order."""
    di = _inner_width(d_model, n_heads, proj_factor)
    dev = gen.device
    return {
        "w_up": dense_init(gen, (d_model, 2 * di), dtype=dtype),
        "conv_w": dense_init(gen, (conv_k, di), scale=0.5, dtype=dtype),
        "w_q": dense_init(gen, (di, di), dtype=dtype),
        "w_k": dense_init(gen, (di, di), dtype=dtype),
        "w_v": dense_init(gen, (di, di), dtype=dtype),
        "w_if": dense_init(gen, (di, 2 * n_heads), scale=0.01,
                           dtype=torch.float32),
        "b_if": torch.cat([torch.zeros((n_heads,), device=dev),
                           torch.linspace(3.0, 6.0, n_heads, device=dev)]
                          ).float(),
        "hnorm": torch.zeros((di,), dtype=torch.float32, device=dev),
        "w_down": dense_init(gen, (di, d_model), dtype=dtype),
    }


def _cummax(x, axis):
    """Running maximum (the reference's ``associative_scan(maximum)``):
    the same values; the gradient goes to the first maximum on a tie."""
    return torch.cummax(x, dim=axis).values


def mlstm_core(q, k, v, logi, logf, carry, chunk: int = 256):
    """q,k,v (B,H,S,Dh) f32; logi,logf (B,H,S) f32.

    carry: (C (B,H,Dh,Dh), n (B,H,Dh), m (B,H)) -- semantics: true state is
    (C,n) * exp(m).  Returns h (B,H,S,Dh) and final carry.  When ``chunk``
    does not divide S the whole sequence is one chunk, as in the
    reference.
    """
    bsz, hh, s, dh = q.shape
    dev = q.device
    k = k / math.sqrt(dh)
    qc = min(chunk, s)
    if s % qc:
        qc = s
    nc = s // qc
    if carry is None:
        carry = (torch.zeros((bsz, hh, dh, dh), dtype=torch.float32,
                             device=dev),
                 torch.zeros((bsz, hh, dh), dtype=torch.float32, device=dev),
                 torch.full((bsz, hh), NEG, dtype=torch.float32, device=dev))

    tri = torch.tril(torch.ones((qc, qc), dtype=torch.bool, device=dev))
    ctil, ntil, m = carry
    hs = []
    for idx in range(nc):
        sl = slice(idx * qc, (idx + 1) * qc)
        qb, kb, vb = q[:, :, sl], k[:, :, sl], v[:, :, sl]
        li, lf = logi[..., sl], logf[..., sl]
        b_cum = torch.cumsum(lf, dim=-1)                     # (B,H,Q)
        g = li - b_cum
        m_intra = b_cum + _cummax(g, -1)
        m_t = torch.maximum(m[..., None] + b_cum, m_intra)   # (B,H,Q)

        inter_scale = torch.exp(m[..., None] + b_cum - m_t)  # (B,H,Q)
        inter_num = inter_scale[..., None] * torch.einsum(
            "bhqd,bhde->bhqe", qb, ctil)
        dmat = (b_cum[..., :, None] - b_cum[..., None, :]
                + li[..., None, :] - m_t[..., None])         # (B,H,Q,Q)
        w = torch.exp(torch.where(tri, dmat, NEG))
        qk = torch.einsum("bhqd,bhjd->bhqj", qb, kb)
        wqk = w * qk
        num = inter_num + torch.einsum("bhqj,bhjd->bhqd", wqk, vb)
        den = (inter_scale * torch.einsum("bhqd,bhd->bhq", qb, ntil)
               + wqk.sum(-1))
        h = num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None]

        # chunk-end state update
        b_last = b_cum[..., -1]
        m_new = torch.maximum(m + b_last, b_last + g.max(-1).values)
        wj = torch.exp(g + (b_last - m_new)[..., None])      # (B,H,Q)
        decay = torch.exp(m + b_last - m_new)
        ctil = (decay[..., None, None] * ctil
                + torch.einsum("bhj,bhjd,bhje->bhde", wj, kb, vb))
        ntil = decay[..., None] * ntil + torch.einsum("bhj,bhjd->bhd", wj,
                                                       kb)
        m = m_new
        hs.append(h)
    return torch.cat(hs, dim=2), (ctil, ntil, m)


def mlstm_block(p, x, n_heads: int, state=None, chunk: int = 256):
    """x (B,S,d_model) -> y, new_state.  Residual applied by caller."""
    b, s, d = x.shape
    xz = x @ p["w_up"]
    di = xz.shape[-1] // 2
    xi, z = xz[..., :di], xz[..., di:]
    xi = hint(xi, "batch", None, "model")
    conv_state = None if state is None else state["conv"]
    xc, new_conv = _causal_conv(xi, p["conv_w"], conv_state)
    xc = F.silu(xc)
    dh = di // n_heads

    def to_heads(t):
        return t.reshape(b, s, n_heads, dh).movedim(1, 2).float()

    q = to_heads(xc @ p["w_q"])
    k = to_heads(xc @ p["w_k"])
    v = to_heads(xi @ p["w_v"])
    gates = xc.float() @ p["w_if"] + p["b_if"]                # (B,S,2H)
    logi = gates[..., :n_heads].movedim(1, 2)
    logf = F.logsigmoid(gates[..., n_heads:].movedim(1, 2))
    carry = None if state is None else state["mem"]
    h, car = mlstm_core(q, k, v, logi, logf, carry, chunk)
    h = h.movedim(2, 1).reshape(b, s, di).to(x.dtype)
    h = rms_norm(h, p["hnorm"])
    y = (h * F.silu(z)) @ p["w_down"]
    return y, {"mem": car, "conv": new_conv}


def init_mlstm_state(batch: int, d_model: int, n_heads: int,
                     proj_factor: float, conv_k: int = 4,
                     dtype=torch.bfloat16, device=None):
    """``device=None`` is the CUDA device (raises when there is none)."""
    device = resolve_device(device)
    di = _inner_width(d_model, n_heads, proj_factor)
    dh = di // n_heads
    return {
        "mem": (torch.zeros((batch, n_heads, dh, dh), dtype=torch.float32,
                            device=device),
                torch.zeros((batch, n_heads, dh), dtype=torch.float32,
                            device=device),
                torch.full((batch, n_heads), NEG, dtype=torch.float32,
                           device=device)),
        "conv": torch.zeros((batch, conv_k - 1, di), dtype=dtype,
                            device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(gen: torch.Generator, d_model: int, n_heads: int,
               dtype=torch.float32):
    """The reference's keys and shapes; the forget gate's bias rises
    from 3 to 6 over the heads, the other biases are 0 (f32)."""
    dh = d_model // n_heads
    dev = gen.device
    fb = torch.linspace(3.0, 6.0, n_heads, device=dev)[:, None] \
        .repeat(1, dh).reshape(-1)
    zeros = torch.zeros((d_model,), device=dev)
    return {
        "w": dense_init(gen, (d_model, 4 * d_model), dtype=dtype),
        "r": dense_init(gen, (n_heads, dh, 4 * dh), scale=0.1, dtype=dtype),
        "b": torch.cat([zeros,                  # z
                        zeros,                  # i
                        fb,                     # f (positive bias)
                        zeros]).float(),        # o
        "hnorm": torch.zeros((d_model,), dtype=torch.float32, device=dev),
    }


def slstm_scan(p, x, n_heads: int, state=None):
    """x (B,S,d) -> h (B,S,d), new state.  Sequential over time."""
    b, s, d = x.shape
    dh = d // n_heads
    zx = x @ p["w"] + p["b"].to(x.dtype)                      # (B,S,4d)
    if state is None:
        state = init_slstm_state(b, d, device=x.device)
    r = p["r"]
    c, n, m, h = state["c"], state["n"], state["m"], state["h"]
    hs = []
    for t in range(s):
        hp = h.reshape(b, n_heads, dh).to(r.dtype)
        rh = torch.einsum("bhd,hde->bhe", hp, r).reshape(b, 4 * d)
        pre = zx[:, t].float() + rh.float()
        zt, it, ft, ot = torch.chunk(pre, 4, dim=-1)
        logf_m = F.logsigmoid(ft) + m
        m_new = torch.maximum(logf_m, it)
        i = torch.exp(it - m_new)
        f = torch.exp(logf_m - m_new)
        c = f * c + i * torch.tanh(zt)
        n = f * n + i
        h = torch.sigmoid(ot) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype), {"c": c, "n": n, "m": m,
                                                "h": h}


def slstm_block(p, x, n_heads: int, state=None):
    h, new_state = slstm_scan(p, x, n_heads, state)
    h = rms_norm(h, p["hnorm"])
    return h, new_state


def init_slstm_state(batch: int, d_model: int, device=None):
    """Zero c, n and h, the stabilizer m at ``NEG``; four distinct
    tensors (decode writes them in place).  ``device=None`` is the CUDA
    device (raises when there is none)."""
    device = resolve_device(device)

    def zeros():
        return torch.zeros((batch, d_model), dtype=torch.float32,
                           device=device)

    return {"c": zeros(), "n": zeros(),
            "m": torch.full((batch, d_model), NEG, dtype=torch.float32,
                            device=device),
            "h": zeros()}
