"""Blockwise online-softmax attention: the CUDA kernels' wrapper and their
plain PyTorch version.

``flash_attention`` replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py: _kernel`` (wrapper
``flash_attention``, GQA wrapper ``kernels/ops.py: gqa_flash_attention``)
with ``csrc/flash_attention.cu``, written by hand for Hopper.  It takes
the model's layout, ``q (B,S,H,D)`` and ``k, v (B,T,Hkv,D)`` with their
strides, and query head ``h`` reads kv head ``h // (H/Hkv)``: the
reference's ``jnp.repeat(k, H/Hkv, axis=2)`` without the repeated copy.
Scale ``1/sqrt(D)`` after the dot, causal and sliding-window masks from
absolute positions (``q_offset`` for the rows), a masked score set to
``-1e30``, f32 ``(acc, m, l)``, a divide by ``max(l, 1e-30)``; a row
that sees no key at all is the mean of v over all ``T`` keys, as in the
reference.  The output is in q's dtype.  ``D`` is 64 (both models) or
16 or 32 (the JAX kernel tests' shapes); ``S`` and ``T`` need not be
tile multiples.

The dtype picks one of two kernels (neither is a fallback of the
other):

* f32 -> the scalar kernel on the CUDA cores: the reference's numerics
  exactly (f32 before the dot, ``expf``); checked at rtol = atol = 2e-5.
* bf16 -> the tensor-core kernel: ``wgmma`` for ``Q.K^T`` and ``P.V``,
  K/V tiles of 128 keys fed by TMA into a 3-stage ring with
  ``mbarrier``s by a producer warp, two consumer warpgroups of 64 q
  rows each (a CTA owns 128 rows) that take turns at the tensor cores
  and run a tile's softmax under the previous tile's ``P.V``, 24
  registers for the producer and 240 for the consumers
  (``setmaxnreg``).  It takes the unnormalised ``P`` into ``P.V`` as
  two bf16 parts (``P`` to about 2^-16, as the reference's f32 ``P``)
  and exp through ``exp2`` (``ex2.approx``): checked at rtol 8e-3,
  atol 1e-3 against the f32 plain version.  Its q, k and v must sit on 16-byte addresses with
  16-byte strides (TMA's rule), or the call raises ``ValueError``.

Bound: per visible (q, k) pair of a head, ``4*D`` flops on the tensor
cores (989e12 flop/s in bf16) and one exp on the special-function units
(16 a clock an SM: 4.18e12/s) -- at D=64 the two are within 8 % of each
other -- against bytes (q, k, v, out once) two orders lower.

A CUDA tensor goes to a kernel or the call raises;
``flash_attention_plain`` (the function of
``repro/kernels/ref.py: flash_attention_ref``, heads folded into the
batch) serves CPU tensors and the checks that hold both kernels
against it.
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG = -1e30

# launches of either CUDA kernel by ``flash_attention`` (and nothing
# else); ``tc_launches`` those of the tensor-core (bf16) kernel alone
launches = 0
tc_launches = 0

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


def tma_misalignment(t) -> str:
    """Why ``t`` (a (B,T,H,D) view) cannot be a TMA source, or ``""``:
    its address and its byte strides of batch, position and head must
    be multiples of 16."""
    esize = t.element_size()
    if t.data_ptr() % 16:
        return f"address {t.data_ptr():#x} is not a multiple of 16 bytes"
    strides = [t.stride(i) * esize for i in range(3)]
    if any(x % 16 for x in strides):
        return f"byte strides {strides} are not all multiples of 16"
    return ""


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

    On a CUDA tensor this launches a kernel on the current stream and
    does not synchronize: the scalar kernel for f32, the tensor-core
    kernel for bf16 (q, k and v of one dtype), a unit stride on D, D in
    ``HEAD_DIMS``, and for bf16 16-byte aligned addresses and strides;
    anything else raises.  On the CPU it is ``gqa_plain``.
    """
    global launches, tc_launches
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
    tensor_cores = q.dtype == torch.bfloat16
    if tensor_cores:
        for name, x in (("q", q), ("k", k), ("v", v)):
            why = tma_misalignment(x)
            if why:
                raise ValueError(f"flash_attention bf16 kernel (TMA): "
                                 f"{name} {why}")
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
    tc_launches += tensor_cores
    return out
