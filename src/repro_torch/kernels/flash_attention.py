"""Blockwise online-softmax attention: the CUDA kernel's wrapper and its
plain PyTorch version.

``flash_attention`` replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py: _kernel`` (wrapper
``flash_attention``, GQA wrapper ``kernels/ops.py: gqa_flash_attention``)
with ``csrc/flash_attention.cu``, written by hand for Hopper.  It takes
the model's layout, ``q (B,S,H,D)`` and ``k, v (B,T,Hkv,D)`` with their
strides, and query head ``h`` reads kv head ``h // (H/Hkv)``: the
reference's ``jnp.repeat(k, H/Hkv, axis=2)`` without the repeated copy.
Scale ``1/sqrt(D)`` after an f32 dot, causal and sliding-window masks
from absolute positions (``q_offset`` for the rows), a masked score set
to ``-1e30``, f32 ``(acc, m, l)``, a divide by ``max(l, 1e-30)``; a row
that sees no key at all is the mean of v over all ``T`` keys, as in the
reference.  The output is in q's dtype.  ``D`` is 64 (both models) or
16 or 32 (the JAX kernel tests' shapes); ``S`` and ``T`` need not be
tile multiples.

Bound: operations, ``4*B*H*S*T_visible*D`` flops, at the serving path's
shapes (hymba-1.5b's window of 1024 at S=4096, about 100 flops a byte).
The kernel is scalar f32 (the reference's numerics): right first, fast
in a later change.

A CUDA tensor goes to the kernel or the call raises;
``flash_attention_plain`` (the function of
``repro/kernels/ref.py: flash_attention_ref``, heads folded into the
batch) serves CPU tensors and the checks that hold the kernel against it.
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG = -1e30

# launches of the CUDA kernel by ``flash_attention`` (and nothing else)
launches = 0

HEAD_DIMS = (16, 32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 3
             + [ctypes.c_float, ctypes.c_void_p])


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          q_offset: int = 0):
    """q (BH,S,D), k/v (BH,T,D), heads folded into the batch -> (BH,S,D)
    in q's dtype: the materialised f32 softmax of ``ref.py:
    flash_attention_ref``."""
    d = q.shape[-1]
    s_ = torch.einsum("bsd,btd->bst", q.float(), k.float()) / math.sqrt(d)
    qp = torch.arange(q.shape[1], device=q.device) + q_offset
    kp = torch.arange(k.shape[1], device=q.device)
    m = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                   device=q.device)
    if causal:
        m &= kp[None, :] <= qp[:, None]
    if window > 0:
        m &= kp[None, :] > qp[:, None] - window
    s_ = torch.where(m[None], s_, torch.full((), NEG, device=q.device))
    p = torch.softmax(s_, dim=-1)
    return torch.einsum("bst,btd->bsd", p, v.float()).to(q.dtype)


def gqa_plain(q, k, v, *, causal: bool = True, window: int = 0,
              q_offset: int = 0):
    """Model layout through the plain version: k/v repeated per group,
    heads folded into the batch (the reference's ``ops.py:
    gqa_flash_attention``)."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    kx = torch.repeat_interleave(k, rep, dim=2)
    vx = torch.repeat_interleave(v, rep, dim=2)

    def fold(t):
        return t.movedim(2, 1).reshape(b * h, t.shape[1], d)

    o = flash_attention_plain(fold(q), fold(kx), fold(vx), causal=causal,
                              window=window, q_offset=q_offset)
    return o.reshape(b, h, s, d).movedim(1, 2)


def _lib():
    from repro_torch.kernels import _build
    lib = _build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        lib.flash_attention_fwd.argtypes = _ARGTYPES
        lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0):
    """q (B,S,H,D); k/v (B,T,Hkv,D) with H a multiple of Hkv ->
    (B,S,H,D) in q's dtype.

    On a CUDA tensor this launches the kernel on the current stream and
    does not synchronize: f32 or bf16 (q, k and v of one dtype), a unit
    stride on D, D in ``HEAD_DIMS``; anything else raises.  On the CPU
    it is ``gqa_plain``.
    """
    global launches
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(
            f"flash_attention: q (B,S,H,D) and k, v (B,T,Hkv,D) with "
            f"H % Hkv == 0 expected, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.device.type != "cuda":
        return gqa_plain(q, k, v, causal=causal, window=window,
                         q_offset=q_offset)

    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes f32 or bf16 q, k, "
                        f"v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head_dim {d} not in "
                         f"{HEAD_DIMS}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention kernel takes a unit stride on D")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}")
    if s < 1 or t < 1 or q_offset < 0:
        raise ValueError(f"flash_attention kernel: S={s}, T={t}, "
                         f"q_offset={q_offset}")
    lib = _lib()
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):      # the launch goes to q's card
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, s, t, h, hkv, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(bool(causal)), int(window), int(q_offset),
            1.0 / math.sqrt(d), torch.cuda.current_stream(q.device)
            .cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out
