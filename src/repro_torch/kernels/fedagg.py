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

``fedagg_fold`` replaces the Pallas TPU kernel ``_fold_kernel``
(wrapper ``fedagg_fold``), the async runtime's staleness window merge,
with a second entry of the same source: client rows ``(K, P)``, the
global model's row ``g (P,)`` as an IMPLICIT row 0, and the telescoped
coefficients ``(K+1,)``, global first.  Same bound (bytes: ``(K*P + 2P)
* 4``, about 222 MB at K=32 of full-width ``cnn-mnist``, 66 us at 3.35
TB/s) and the same row loop as ``fedagg``.

``fedagg_partial`` replaces the Pallas TPU kernel ``_partial_kernel``
(wrapper ``fedagg_partial``), the per-shard term of the client mesh's
reductions (``distributed/aggregate.py``), with a third entry of the
same source: rows ``(R, P)`` and coefficients ``(R,)`` -> the
UNnormalised masked row sum ``sum_r c_r * u_r``; the caller adds the
shards' sums and normalises.  Bound: bytes, ``(R_live*P + P) * 4`` —
the mesh path's shards hold 1-2 rows of full-width ``cnn-mnist``, 13-20
MB, 4-6 us at 3.35 TB/s.

All three kernels, and the plain versions beside them, sum rows in one fixed
sequential order and skip a masked row before it is read, so rows of
coefficient 0 appended to a call (the engine's padded cohorts) leave
every output bit unchanged.  ``torch.sum`` over rows does not promise
that: its blocking depends on the row count.

Up to ``fedagg_max_rows()`` (4,096) rows each can be one launch whose
coefficients sit in shared memory.  Past it, and on tall calls under
it (``tiled_route``: from 128 rows), the same entry's tiled twin
(``csrc/fedagg.cu``: ``*_ws``) runs two launches on the stream, a
one-block preamble that writes the packed coefficients into a device
workspace (``fedagg_ws_floats(n)`` floats, allocated here with
``torch.empty``) and the stream folding the packed rows through a ring
of rows in flight a thread, in blocks sized so that short rows fill
every SM: the same arithmetic in the same order, so the bits are those
of one launch and rows of coefficient 0 appended past 4,096 still
change none.  The tiled route takes up to ``fedagg_ws_max_rows()``
(2^30) rows, the limit of its int row indices; more raise
``ValueError``.

A CUDA tensor goes to the kernel or the call raises; ``fedagg_plain``,
``fedagg_fold_plain`` and ``fedagg_partial_plain`` serve CPU tensors
and the checks that hold the kernels against them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

# launches of the CUDA kernels by ``fedagg``, ``fedagg_fold`` and
# ``fedagg_partial`` (and nothing else), a call past fedagg_max_rows()
# counted once; ``tiled_launches`` counts those calls of all three
launches = 0
fold_launches = 0
partial_launches = 0
tiled_launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p]
_PARTIAL_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_void_p]
# each entry's tiled twin takes the workspace after its output
_ENTRIES = {"fedagg_f32": _ARGTYPES, "fedagg_fold_f32": _ARGTYPES,
            "fedagg_partial_f32": _PARTIAL_ARGTYPES}


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


def _f32_on(x, device):
    """A small vector (numpy, list or tensor) -> contiguous f32 on
    ``device``.  A host vector bound for a CUDA device is staged in
    pinned memory and copied without blocking: a copy from pageable
    memory would first wait for the stream to drain."""
    device = torch.device(device)
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu" or device.type != "cuda":
            return x.to(device=device, dtype=torch.float32).contiguous()
        x = x.to(torch.float32).contiguous()
    else:
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    if device.type != "cuda":
        return x.to(device)
    return x.pin_memory().to(device, non_blocking=True)


def ordered_sum(v):
    """Sum of a small f32 vector in index order, one add at a time, as
    the kernels' single thread takes it: trailing zeros change no bit of
    it, which ``torch.sum`` does not promise."""
    total = torch.zeros((), dtype=torch.float32, device=v.device)
    for i in range(v.shape[0]):
        total = total + v[i]
    return total


def fold_coefficients(coef, device):
    """(K+1,) merge coefficients -> masked, normalised f32 on ``device``:
    ``c = c > 0 ? c : 0`` (NaN -> 0), divided by ``max(sum c, 1e-30)``
    (``ordered_sum``)."""
    c = _f32_on(coef, device)
    c = torch.where(c > 0.0, c, torch.zeros_like(c))
    return c / torch.clamp(ordered_sum(c), min=1e-30)


def row_sum(updates, c):
    """``sum_k c_k*u_k`` in f32, the rows added one at a time in row
    order; a row with ``c_k <= 0`` (or NaN) is zeroed, with its
    coefficient, before the multiply, so appended rows of coefficient 0
    leave every bit unchanged.  ``updates`` (K, ...), ``c`` (K,)."""
    zero = torch.zeros((), dtype=torch.float32, device=updates.device)
    acc = torch.zeros(updates.shape[1:], dtype=torch.float32,
                      device=updates.device)
    for k in range(updates.shape[0]):
        live = c[k] > 0.0
        acc = acc + (torch.where(live, updates[k].float(), zero)  # fedlint: disable=FED003 -- eager PyTorch runs the multiply and the add as two operations, never contracted; padded == unpadded and store == dict are test-pinned
                     * torch.where(live, c[k], zero))
    return acc


def fold_rows(updates, g, c):
    """``(c0 > 0 ? c0*g : 0) + sum_k c_k*u_k`` in f32 (``row_sum``).
    ``updates`` (K, ...), ``g`` (...), ``c`` the (K+1,) output of
    ``fold_coefficients``."""
    zero = torch.zeros((), dtype=torch.float32, device=updates.device)
    c0 = c[0]
    return torch.where(c0 > 0.0, c0 * g.float(), zero) + row_sum(updates,
                                                                   c[1:])


def fedagg_fold_plain(updates, g, coef):
    """Plain PyTorch version of the folded window merge: updates (K,P),
    g (P,), coef (K+1,) -> (P,) in ``updates.dtype``."""
    c = fold_coefficients(coef, updates.device)
    return fold_rows(updates, g, c).to(updates.dtype)


def fedagg_partial_plain(updates, coef):
    """Plain PyTorch version of one shard's partial sum: updates (R,P),
    coef (R,) -> the unnormalised masked row sum (P,) in
    ``updates.dtype``."""
    c = _f32_on(coef, updates.device)
    return row_sum(updates, c).to(updates.dtype)


def _lib():
    from repro_torch.kernels import _build
    lib = _build.load("fedagg")
    if lib.fedagg_f32.argtypes is None:
        for name, types in _ENTRIES.items():
            cut = types.index(ctypes.c_int)
            for fn, t in ((name, types),
                          (f"{name}_ws", [*types[:cut], ctypes.c_void_p,
                                          *types[cut:]])):
                getattr(lib, fn).argtypes = t
                getattr(lib, fn).restype = ctypes.c_int
        for fn in ("fedagg_max_rows", "fedagg_ws_max_rows"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = ctypes.c_int
        lib.fedagg_ws_floats.argtypes = [ctypes.c_int]
        lib.fedagg_ws_floats.restype = ctypes.c_longlong
    return lib


# The route by shape (``tiled_route``): the single launch keeps a batch
# of 16 rows a thread in flight, then drains it; the tiled route keeps a
# ring of 32 float4 (64 narrower) rows a thread in flight with no gap,
# after a one-block preamble launch.  From 128 rows the ring is faster
# at resnet8-cifar10's 77,594 floats and at 131,072, and ties at
# cnn-mnist's 1,630,090; below, its preamble's launch and serial sum
# outweigh it (tools/fedagg_variants.py --grid, the table in PERF.md).
ROUTE_ROWS = 128


def tiled_route(held: int, single_max: int = 4096) -> bool:
    """Whether a call that holds ``held`` coefficients (``fedagg_fold``:
    its rows + 1) takes the tiled route: from ``ROUTE_ROWS`` on, and
    always past the single launch's ``single_max``.  Both routes give
    the same bits."""
    return held >= ROUTE_ROWS or held > single_max


def _workspace(lib, what: str, rows: int, device, held=None):
    """None when the single launch takes the call (``tiled_route`` of
    ``held`` coefficients, ``rows`` unless given: ``fedagg_fold`` holds
    its rows + 1, against its ``fedagg_max_rows()``); else the
    (``fedagg_ws_floats(rows)``,) f32 workspace of the tiled route on
    ``device``.  Raises past the tiled route's
    ``fedagg_ws_max_rows()``."""
    if not tiled_route(rows if held is None else held,
                       lib.fedagg_max_rows()):
        return None
    limit = lib.fedagg_ws_max_rows()
    if rows > limit:
        raise ValueError(f"{what} kernel: {rows} rows exceed the {limit} "
                         "that its int row indices and workspace offsets "
                         "hold")
    return torch.empty((int(lib.fedagg_ws_floats(rows)),),
                       dtype=torch.float32, device=device)


def _launch(lib, entry: str, ws, args, stream) -> int:
    """``entry`` on ``args`` (all but the stream), or, with a workspace,
    its tiled twin with the workspace's address after the output."""
    global tiled_launches
    if ws is None:
        return getattr(lib, entry)(*args, stream)
    cut = _ENTRIES[entry].index(ctypes.c_int)
    err = getattr(lib, f"{entry}_ws")(*args[:cut], ws.data_ptr(),
                                      *args[cut:], stream)
    tiled_launches += err == 0
    return err


def _vector_width(p: int, *tensors) -> int:
    """Widest 4/2/1-float vector that divides ``p`` and to which every
    tensor's start is aligned (so every row start is too)."""
    for vec in (4, 2):
        nbytes = 4 * vec
        if p % vec == 0 and all(t.data_ptr() % nbytes == 0
                                for t in tensors):
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
    dev = updates.device
    ws = _workspace(lib, "fedagg", n, dev)
    w = weights.to(device=dev, dtype=torch.float32).contiguous()
    a = (None if alphas is None
         else alphas.to(device=dev, dtype=torch.float32).contiguous())
    out = torch.empty((p,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):          # the launch goes to `dev`
        err = _launch(lib, "fedagg_f32", ws,
                      (updates.data_ptr(), w.data_ptr(),
                       None if a is None else a.data_ptr(), out.data_ptr(),
                       n, p, _vector_width(p, updates, out)),
                      torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fedagg kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def fedagg_fold(updates, g, coef):
    """Folded staleness window merge: updates (K,P), global row g (P,),
    coef (K+1,) -> merged row (P,).

    ``coef`` is in ``staleness_merge_coefficients`` order, the global
    model's coefficient first.  Coefficients are masked at <= 0 and
    normalised (the fedagg convention): masked stragglers and padded
    rows contribute nothing, and all-zero coefficients give zeros.  On a
    CUDA tensor this launches the kernel on the current stream and does
    not synchronize; it takes contiguous f32 ``updates`` and ``g`` and
    raises on anything else.
    """
    global fold_launches
    if updates.ndim != 2 or g.shape != (updates.shape[1],) \
            or tuple(np.shape(coef)) != (updates.shape[0] + 1,):
        raise ValueError(
            f"fedagg_fold: updates (K,P), g (P,) and coef (K+1,) "
            f"expected, got {tuple(updates.shape)}, {tuple(g.shape)} and "
            f"{tuple(np.shape(coef))}")
    if updates.device.type != "cuda":
        return fedagg_fold_plain(updates, g, coef)

    k, p = updates.shape
    if updates.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"fedagg_fold kernel takes f32 rows, got "
                        f"{updates.dtype} and {g.dtype}")
    if not (updates.is_contiguous() and g.is_contiguous()):
        raise ValueError("fedagg_fold kernel takes a contiguous (K,P) "
                         "buffer and a contiguous (P,) row")
    if g.device != updates.device:
        raise ValueError(f"fedagg_fold: g on {g.device}, updates on "
                         f"{updates.device}")
    if k < 1 or p < 1:
        raise ValueError(f"fedagg_fold kernel: empty buffer {k}x{p}")
    lib = _lib()
    dev = updates.device
    ws = _workspace(lib, "fedagg_fold", k, dev, held=k + 1)
    c = _f32_on(coef, dev)
    out = torch.empty((p,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):          # the launch goes to `dev`
        err = _launch(lib, "fedagg_fold_f32", ws,
                      (updates.data_ptr(), g.data_ptr(), c.data_ptr(),
                       out.data_ptr(), k, p,
                       _vector_width(p, updates, g, out)),
                      torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"fedagg_fold kernel launch failed: CUDA error {err}")
    fold_launches += 1
    return out


def fedagg_partial(updates, coef):
    """One shard's term of the client mesh's reductions: updates (R,P),
    coef (R,) -> ``sum_r c_r * u_r`` (P,), NOT normalised.

    Rows with ``c_r <= 0`` (or NaN) are skipped before they are read,
    so inf/nan in them cannot reach the sum; all-zero coefficients give
    zeros.  On a CUDA tensor this launches the kernel on the current
    stream and does not synchronize; it takes contiguous f32 ``updates``
    and raises on anything else.
    """
    global partial_launches
    if updates.ndim != 2 or tuple(np.shape(coef)) != (updates.shape[0],):
        raise ValueError(
            f"fedagg_partial: updates (R,P) and coef (R,) expected, got "
            f"{tuple(updates.shape)} and {tuple(np.shape(coef))}")
    if updates.device.type != "cuda":
        return fedagg_partial_plain(updates, coef)

    n, p = updates.shape
    if updates.dtype != torch.float32:
        raise TypeError(
            f"fedagg_partial kernel takes f32 rows, got {updates.dtype}")
    if not updates.is_contiguous():
        raise ValueError("fedagg_partial kernel takes a contiguous (R,P) "
                         "buffer")
    if n < 1 or p < 1:
        raise ValueError(f"fedagg_partial kernel: empty buffer {n}x{p}")
    lib = _lib()
    dev = updates.device
    ws = _workspace(lib, "fedagg_partial", n, dev)
    c = _f32_on(coef, dev)
    out = torch.empty((p,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):          # the launch goes to `dev`
        err = _launch(lib, "fedagg_partial_f32", ws,
                      (updates.data_ptr(), c.data_ptr(), out.data_ptr(), n,
                       p, _vector_width(p, updates, out)),
                      torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"fedagg_partial kernel launch failed: CUDA error {err}")
    partial_launches += 1
    return out
