"""Diagonal selective-SSM scan: the CUDA kernel's wrapper and its plain
PyTorch version.

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,   A = -exp(a_log)
    y_t = <h_t, C_t>

``ssm_scan`` replaces the Pallas TPU kernel ``repro/kernels/ssm_scan.py:
_kernel`` (wrapper ``ssm_scan``, ``kernels/ops.py: ssm_scan_op``) with
``csrc/ssm_scan.cu``, written by hand for Hopper.  Beyond the TPU
kernel's function it takes a starting state ``h0 (B,D,N)`` f32 (zeros
when absent) and returns the final state ``h_end (B,D,N)`` f32, so the
model's ``ssm_core`` (h0 in, h_end out) is one launch on every path:
the prefill and a decode step (S = 1) with a carried state alike.
``b_in`` and ``c_out`` may be strided views (the two halves of the
model's ``(B,S,2N)`` projection); no copy is made.

The kernel splits time: a block is one chunk of one row's channel
group, each of its warps scans a segment of the chunk from a zero
state, the carries between segments are folded in registers (N exps a
segment), and each segment is rerun from its carry to write y; a chunk's
carry-in comes from the block of the chunk before through global
memory, so the wrapper allocates a small scratch a call (zeroed tickets
and flags, and the carries).  A decode step (S = 1) is a separate
one-step kernel in the same entry, with no scratch.  Bound: the ``B*S*D*N`` exps (the design
takes each twice, once per pass; bytes are below both).  The arithmetic
order is emulated on the CPU in ``tests/test_torch_ssm.py``.

A CUDA tensor goes to the kernel or the call raises; ``ssm_scan_plain``
(a sequential recurrence, as ``repro/kernels/ref.py: ssm_scan_ref``)
serves CPU tensors and the checks that hold the kernel against it.
"""

from __future__ import annotations

import ctypes

import torch

# launches of the CUDA kernel by ``ssm_scan`` (and nothing else)
launches = 0

STATE_SIZES = (4, 8, 16)       # hymba's 16; the JAX kernel tests' 4, 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 12 + [ctypes.c_void_p] * 3)
_SCRATCH_ARGTYPES = [ctypes.c_int] * 5


def ssm_scan_plain(x, dt, b_in, c_out, a_log, h0=None):
    """x, dt (B,S,D); b_in, c_out (B,S,N); a_log (D,N); h0 (B,D,N) or
    None -> (y (B,S,D) in x's dtype, h_end (B,D,N) f32): one step at a
    time in f32, as ``ref.py: ssm_scan_ref``."""
    a_neg = -torch.exp(a_log.float())
    bsz, s, d = x.shape
    n = b_in.shape[-1]
    h = (torch.zeros((bsz, d, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    xf, dtf = x.float(), dt.float()
    bf, cf = b_in.float(), c_out.float()
    ys = []
    for t in range(s):
        da = torch.exp(dtf[:, t, :, None] * a_neg[None])       # (B,D,N)
        dbx = (dtf[:, t] * xf[:, t])[:, :, None] * bf[:, t, None, :]
        h = da * h + dbx  # fedlint: disable=FED003 -- SSM recurrence in eager PyTorch (separate multiply and add ops); the kernel is tolerance-gated against it, not bit-identity-gated
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h


def _lib():
    from repro_torch.kernels import _build
    lib = _build.load("ssm_scan")
    if lib.ssm_scan_fwd.argtypes is None:
        lib.ssm_scan_fwd.argtypes = _ARGTYPES
        lib.ssm_scan_fwd.restype = ctypes.c_int
        lib.ssm_scan_scratch.argtypes = _SCRATCH_ARGTYPES
        lib.ssm_scan_scratch.restype = ctypes.c_longlong
    return lib


def ssm_scan(x, dt, b_in, c_out, a_log, h0=None):
    """x, dt (B,S,D); b_in, c_out (B,S,N); a_log (D,N) f32; h0 (B,D,N)
    f32 or None -> (y (B,S,D) in x's dtype, h_end (B,D,N) f32).

    On a CUDA tensor this launches the kernel on the current stream and
    does not synchronize: x, dt, b_in, c_out f32 or bf16 of one dtype
    (any strides), N in ``STATE_SIZES``; anything else raises.  On the
    CPU it is ``ssm_scan_plain``.
    """
    global launches
    if x.ndim != 3 or dt.shape != x.shape or b_in.ndim != 3 \
            or c_out.shape != b_in.shape or b_in.shape[:2] != x.shape[:2] \
            or tuple(a_log.shape) != (x.shape[2], b_in.shape[2]):
        raise ValueError(
            f"ssm_scan: x, dt (B,S,D), b_in, c_out (B,S,N) and a_log "
            f"(D,N) expected, got {tuple(x.shape)}, {tuple(dt.shape)}, "
            f"{tuple(b_in.shape)}, {tuple(c_out.shape)}, "
            f"{tuple(a_log.shape)}")
    bsz, s, d = x.shape
    n = b_in.shape[2]
    if h0 is not None and tuple(h0.shape) != (bsz, d, n):
        raise ValueError(f"ssm_scan: h0 {tuple(h0.shape)} is not "
                         f"{(bsz, d, n)}")
    if x.device.type != "cuda":
        return ssm_scan_plain(x, dt, b_in, c_out, a_log, h0)

    if x.dtype not in _DTYPES or any(t.dtype != x.dtype
                                     for t in (dt, b_in, c_out)):
        raise TypeError(f"ssm_scan kernel takes f32 or bf16 x, dt, b_in, "
                        f"c_out of one dtype, got {x.dtype}, {dt.dtype}, "
                        f"{b_in.dtype}, {c_out.dtype}")
    if a_log.dtype != torch.float32 or not a_log.is_contiguous():
        raise TypeError("ssm_scan kernel takes a contiguous f32 a_log")
    if h0 is not None and (h0.dtype != torch.float32
                           or not h0.is_contiguous()):
        raise TypeError("ssm_scan kernel takes a contiguous f32 h0")
    if n not in STATE_SIZES:
        raise ValueError(f"ssm_scan kernel: state size {n} not in "
                         f"{STATE_SIZES}")
    if any(t.device != x.device for t in (dt, b_in, c_out, a_log)) or (
            h0 is not None and h0.device != x.device):
        raise ValueError("ssm_scan: every input must be on x's device")
    if s < 1 or d < 1:
        raise ValueError(f"ssm_scan kernel: S={s}, D={d}")
    lib = _lib()
    y = torch.empty((bsz, s, d), dtype=x.dtype, device=x.device)
    h_end = torch.empty((bsz, d, n), dtype=torch.float32, device=x.device)
    # the time split's scratch: zeroed tickets and flags, and the chunks'
    # carries (none for a decode step)
    sync = carries = None
    if s > 1:
        sync = torch.zeros(lib.ssm_scan_scratch(bsz, s, d, n, 0),
                           dtype=torch.int32, device=x.device)
        carries = torch.empty(lib.ssm_scan_scratch(bsz, s, d, n, 1),
                              dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):      # the launch goes to x's card
        err = lib.ssm_scan_fwd(
            x.data_ptr(), dt.data_ptr(), b_in.data_ptr(), c_out.data_ptr(),
            a_log.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_end.data_ptr(), _DTYPES[x.dtype], bsz, s, d, n,
            *x.stride(), *dt.stride(), *b_in.stride(), *c_out.stride(),
            torch.cuda.current_stream(x.device).cuda_stream,
            None if sync is None else sync.data_ptr(),
            None if carries is None else carries.data_ptr())
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return y, h_end
