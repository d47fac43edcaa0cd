"""Shared functional building blocks (plain functions on trees of
tensors), the JAX package's ``models/layers.py``.

Initialisers draw from an explicit ``torch.Generator`` on that
generator's device: a CUDA generator draws a full-width model on the
card.  ``device="meta"`` makes the tensors on ``meta`` in place of
``gen``'s device and draws nothing: shapes and dtypes only, the
abstract trees of ``launch/steps.py``.  Numerics follow the reference:
norms in f32, cast back to the input's dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def init_device(gen: torch.Generator, device=None) -> torch.device:
    """Where an initialiser makes its tensors: ``device``, else
    ``gen``'s device."""
    return gen.device if device is None else torch.device(device)


def dense_init(gen: torch.Generator, shape, scale: float | None = None,
               dtype=torch.float32, device=None):
    """Truncated-normal fan-in init (LeCun-ish, like maxtext defaults):
    a standard normal cut at +-2, times ``scale`` (default
    ``1/sqrt(fan_in)``), drawn in f32 on ``gen``'s device (on ``meta``:
    no draw)."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32,
                    device=init_device(gen, device))
    if w.is_meta:
        return w.to(dtype)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    return w.mul_(scale).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32,
               device=None):
    w = torch.empty(shape, dtype=torch.float32,
                    device=init_device(gen, device))
    if w.is_meta:
        return w.to(dtype)
    return w.normal_(0.0, 1.0, generator=gen).mul_(0.02).to(dtype)


def rms_norm(x, scale, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def activate(h_gate, h_up, kind: str):
    """Fused MLP activation.  For non-gated kinds ``h_gate`` is the input."""
    if kind == "swiglu":
        return F.silu(h_gate) * h_up
    if kind == "squared_relu":
        r = F.relu(h_gate)
        return r * r
    if kind == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        return F.gelu(h_gate, approximate="tanh")
    if kind == "relu":
        return F.relu(h_gate)
    raise ValueError(kind)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, kind: str,
             dtype=torch.float32, device=None):
    """Same keys as the reference; drawn in the order w_gate, w_up,
    w_down."""
    p = {}
    if kind == "swiglu":
        p["w_gate"] = dense_init(gen, (d_model, d_ff), dtype=dtype,
                                 device=device)
    p["w_up"] = dense_init(gen, (d_model, d_ff), dtype=dtype, device=device)
    p["w_down"] = dense_init(gen, (d_ff, d_model), dtype=dtype,
                             device=device)
    return p


def mlp(p, x, kind: str):
    if kind == "swiglu":
        h = activate(x @ p["w_gate"], x @ p["w_up"], kind)
    else:
        h = activate(x @ p["w_up"], None, kind)
    return h @ p["w_down"]


def take_embedding(table, ids):
    return table[ids]
