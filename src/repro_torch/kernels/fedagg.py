"""Weighted federated aggregation: the CUDA kernel's wrapper and its
plain PyTorch version.

The FedDCT server's hot loop: ``w_global = sum_c (s_c / sum s) * w_c``
over the stacked client updates ``(N, P)``.  Weight normalization AND
straggler masking are fused: a row whose effective weight
``w_c * alpha_c`` is not positive (a dropped client) is left out before
the reduction, so non-finite garbage in it can never reach the average
and the scheduler never has to re-pack the buffer after a drop.  If
every effective weight is zero the result is all-zeros.

``fedagg`` replaces the Pallas TPU kernel ``repro/kernels/fedagg.py:
_kernel`` (wrapper ``fedagg``) with ``csrc/fedagg.cu``, written by hand
for Hopper.  It is bound by bytes: ``(N*P + P) * 4`` of them over the
card's memory rate — at the main path's shape, N=32 rows of
P=1,630,090 f32 (full-width ``cnn-mnist``), about 209 MB, so about
62 us on an H100 SXM at 3.35 TB/s.  The kernel therefore reads every
live row element exactly once with vector loads, keeps the sums in
registers, masks the ragged tail itself (no padded copy of the
buffer) and skips dropped rows before loading them.

A CUDA tensor goes to the kernel or the call raises; ``fedagg_plain``
serves CPU tensors and the checks that hold the kernel against it.
"""

from __future__ import annotations

import ctypes

import torch

# launches of the CUDA kernel by ``fedagg`` (and nothing else)
launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p]


def fedagg_plain(updates, weights, alphas=None):
    """Plain PyTorch version: updates (N,P), weights (N,) -> (P,), f32
    accumulate, output in ``updates.dtype``."""
    w = weights.float()
    if alphas is not None:
        w = w * alphas.float()
    live = w > 0.0
    u = torch.where(live[:, None], updates.float(),
                    torch.zeros((), dtype=torch.float32,
                                device=updates.device))
    w = torch.where(live, w, torch.zeros_like(w))
    w = w / torch.clamp(w.sum(), min=1e-30)
    return (u * w[:, None]).sum(dim=0).to(updates.dtype)


def _lib():
    from repro_torch.kernels import _build
    lib = _build.load("fedagg")
    if lib.fedagg_f32.argtypes is None:
        lib.fedagg_f32.argtypes = _ARGTYPES
        lib.fedagg_f32.restype = ctypes.c_int
        lib.fedagg_max_rows.argtypes = []
        lib.fedagg_max_rows.restype = ctypes.c_int
    return lib


def _vector_width(updates, out) -> int:
    """Widest 4/2/1-float vector at which every row start is aligned."""
    p = updates.shape[1]
    for vec in (4, 2):
        nbytes = 4 * vec
        if (p % vec == 0 and updates.data_ptr() % nbytes == 0
                and out.data_ptr() % nbytes == 0):
            return vec
    return 1


def fedagg(updates, weights, *, alphas=None):
    """updates (N,P), weights (N,) -> weighted average (P,).

    ``sum_c eff_c * u_c / sum(eff)`` with ``eff_c = w_c * alpha_c``
    (``alphas=None`` -> all ones).  On a CUDA tensor this launches the
    kernel on the current stream and does not synchronize; it takes
    contiguous f32 ``updates`` and raises on anything else.
    """
    global launches
    if updates.ndim != 2 or weights.shape != (updates.shape[0],):
        raise ValueError(
            f"fedagg: updates (N,P) and weights (N,) expected, got "
            f"{tuple(updates.shape)} and {tuple(weights.shape)}")
    if alphas is not None and alphas.shape != weights.shape:
        raise ValueError("fedagg: alphas must have the shape of weights")
    if updates.device.type != "cuda":
        return fedagg_plain(updates, weights, alphas)

    n, p = updates.shape
    if updates.dtype != torch.float32:
        raise TypeError(f"fedagg kernel takes f32 rows, got {updates.dtype}")
    if not updates.is_contiguous():
        raise ValueError("fedagg kernel takes a contiguous (N,P) buffer")
    if n < 1 or p < 1:
        raise ValueError(f"fedagg kernel: empty buffer {n}x{p}")
    lib = _lib()
    max_rows = lib.fedagg_max_rows()
    if n > max_rows:
        raise ValueError(f"fedagg kernel: {n} rows exceed the {max_rows} "
                         "whose weights fit its shared memory")
    dev = updates.device
    w = weights.to(device=dev, dtype=torch.float32).contiguous()
    a = (None if alphas is None
         else alphas.to(device=dev, dtype=torch.float32).contiguous())
    out = torch.empty((p,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):          # the launch goes to `dev`
        err = lib.fedagg_f32(updates.data_ptr(), w.data_ptr(),
                             None if a is None else a.data_ptr(),
                             out.data_ptr(), n, p,
                             _vector_width(updates, out),
                             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fedagg kernel launch failed: CUDA error {err}")
    launches += 1
    return out
