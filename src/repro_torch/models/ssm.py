"""Mamba-style selective SSM (diagonal state space), the JAX package's
``models/ssm.py``.

On the CPU, prefill is the reference's chunked parallel scan: the
sequence is processed in chunks of Q steps; within a chunk the
(B,Q,d_in,n) discretized tensors are materialized and combined with an
associative scan (log-step doubling); the hidden state (B,d_in,n) is
carried across chunks.  On a CUDA tensor ``ssm_core`` is ONE launch of
the hand-written scan kernel (``kernels/ssm_scan.py: ssm_scan``), state
``h0`` in and ``h_end`` out, for a prefill and a decode step (S = 1)
alike.  Decode is a single recurrent step through the same layer.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.kernels import ssm_scan as ssm_kernel
from repro_torch.models.layers import dense_init
from repro_torch.sharding.hints import hint


def init_ssm(gen: torch.Generator, d_model: int, n_state: int,
             expand: int = 2, conv_k: int = 4, dtype=torch.float32):
    """The reference's keys and shapes; A_log = log(1..n) per channel,
    dt_bias = softplus^-1 of dt drawn log-uniform in [1e-3, 1e-1]."""
    d_in = expand * d_model
    dev = gen.device
    u = torch.empty((d_in,), dtype=torch.float32, device=dev).uniform_(
        math.log(1e-3), math.log(1e-1), generator=gen)
    dt_init = torch.log(torch.expm1(torch.exp(u)))
    a_log = torch.log(torch.arange(1, n_state + 1, dtype=torch.float32,
                                   device=dev))
    return {
        "w_in": dense_init(gen, (d_model, 2 * d_in), dtype=dtype),
        "conv_w": dense_init(gen, (conv_k, d_in), scale=0.5, dtype=dtype),
        "w_bc": dense_init(gen, (d_in, 2 * n_state), dtype=dtype),
        "w_dt": dense_init(gen, (d_in, d_in), scale=0.01, dtype=dtype),
        "dt_bias": dt_init,
        "A_log": a_log[None, :].repeat(d_in, 1),             # (d_in,n)
        "D": torch.ones((d_in,), dtype=torch.float32, device=dev),
        "w_out": dense_init(gen, (d_in, d_model), dtype=dtype),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv.  x (B,S,di), w (K,di).  state (B,K-1,di)."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(k))
    new_state = xp[:, -(k - 1):, :] if k > 1 else None
    return out, new_state


def _discretize(dt, bc, xc, a_neg, n_state):
    """dt (B,Q,di); bc (B,Q,2n); xc (B,Q,di) -> dA,dBx (B,Q,di,n), C (B,Q,n)."""
    b_in, c_out = bc[..., :n_state], bc[..., n_state:]
    da = torch.exp(dt[..., None] * a_neg[None, None])          # (B,Q,di,n)
    dbx = (dt * xc)[..., None] * b_in[:, :, None, :]
    return da, dbx, c_out


def _chunk_scan(da, dbx, h0):
    """Associative scan of h_t = da_t*h + dbx_t within a chunk, by
    log-step doubling with the reference's combine
    ``(al, bl), (ar, br) -> (al*ar, bl*ar + br)``.

    da, dbx: (B,Q,di,n) f32; h0: (B,di,n).  Returns hs (B,Q,di,n), h_end.
    """
    a_cum, b_cum = da, dbx
    off, q = 1, da.shape[1]
    while off < q:
        b_cum = torch.cat([b_cum[:, :off],
                           b_cum[:, :-off] * a_cum[:, off:] + b_cum[:, off:]],
                          dim=1)
        a_cum = torch.cat([a_cum[:, :off], a_cum[:, :-off] * a_cum[:, off:]],
                          dim=1)
        off *= 2
    hs = b_cum + a_cum * h0[:, None]
    return hs, hs[:, -1]


def _kernel_route(x) -> bool:
    """True when the scan goes to the kernel: a CUDA tensor."""
    return x.device.type == "cuda"


def ssm_core(p, xc, dt, bc, h0, n_state: int, chunk: int = 256):
    """Chunked selective scan.  xc,dt (B,S,di); bc (B,S,2n); h0 (B,di,n)
    f32 or None -> (y (B,S,di) in xc's dtype, h_end (B,di,n) f32)."""
    if _kernel_route(xc):
        return ssm_kernel.ssm_scan(xc, dt, bc[..., :n_state],
                                   bc[..., n_state:], p["A_log"], h0)
    b, s, di = xc.shape
    a_neg = -torch.exp(p["A_log"].float())                     # (di,n)
    q = min(chunk, s)
    if s % q:
        q = s
    h = (torch.zeros((b, di, n_state), dtype=torch.float32, device=xc.device)
         if h0 is None else h0)
    ys = []
    for idx in range(s // q):
        sl = slice(idx * q, (idx + 1) * q)
        da, dbx, c_out = _discretize(dt[:, sl].float(), bc[:, sl].float(),
                                     xc[:, sl].float(), a_neg, n_state)
        da = hint(da, "batch", None, "model", None)
        dbx = hint(dbx, "batch", None, "model", None)
        hs, h = _chunk_scan(da, dbx, h)
        ys.append(torch.einsum("bqdn,bqn->bqd", hs, c_out.float()))
    return torch.cat(ys, dim=1).to(xc.dtype), h


def _softplus(x):
    """jax.nn.softplus: logaddexp(x, 0), with no linear cut-off."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssm_forward(p, x, *, n_state: int, chunk: int = 256, state=None):
    """Full layer.  x (B,S,d_model) -> y, new_state (for decode handoff).

    state = {"h": (B,di,n), "conv": (B,K-1,di)} or None.
    """
    xz = x @ p["w_in"]
    di = xz.shape[-1] // 2
    xp, z = xz[..., :di], xz[..., di:]
    xp = hint(xp, "batch", None, "model")   # channel-parallel SSM heads
    conv_state = None if state is None else state["conv"]
    xp, new_conv = _causal_conv(xp, p["conv_w"], conv_state)
    xp = F.silu(xp)
    dt = _softplus(xp @ p["w_dt"] + p["dt_bias"].to(xp.dtype))
    bc = xp @ p["w_bc"]
    h0 = None if state is None else state["h"]
    y, h_end = ssm_core(p, xp, dt, bc, h0, n_state, chunk)
    y = y + p["D"].to(y.dtype) * xp
    out = (y * F.silu(z)) @ p["w_out"]
    new_state = {"h": h_end, "conv": new_conv}
    return out, new_state


def init_ssm_state(batch: int, d_model: int, n_state: int, expand: int,
                   conv_k: int, dtype=torch.bfloat16, device=None):
    """The decode state on ``device`` (``resolve_device``: ``cuda``
    unless ``"cpu"`` is passed)."""
    device = resolve_device(device)
    di = expand * d_model
    return {"h": torch.zeros((batch, di, n_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, conv_k - 1, di), dtype=dtype,
                                device=device)}


def ssm_decode_step(p, x, state, *, n_state: int):
    """x (B,1,d_model) single step."""
    return ssm_forward(p, x, n_state=n_state, chunk=1, state=state)
