"""Rotary position embeddings: angles in f32, the result cast back to
``x.dtype`` (the JAX package's ``models/rope.py``)."""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # (D/2,)
    positions = torch.as_tensor(positions, device=x.device)
    angles = positions[..., None].float() * freqs            # (..., S, D/2)
    angles = angles[..., None, :]                            # (..., S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat(
        [x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
