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

Gradients.  When grad mode is on and an input requires grad,
``ssm_scan`` goes through ``SSMScanFn``: the forward kernel, which
keeps its chunk carries (the state at the start of every chunk but the
first, ``carries``; not one bit of y or h_end changes), and for the
backward ``csrc/ssm_scan_bwd.cu: ssm_scan_bwd`` (f32 or bf16 inputs,
widened where they are read; states, carries, partials and the
gradients' sums f32, the gradients rounded to the inputs' dtype after
the launch), split over time as
the forward is: a block is one chunk of one row's channel group, each
warp scans its segment forward and g backward from zero, the carries
between segments are folded in registers (the forward's from its kept
chunk carry, g's from the later chunk's block through a flag), and
each segment is replayed from its true state in register sub-blocks
and walked back.  Its cross-block sums come back as partials -- dB and
dC per channel group, dA_log per (batch row, chunk) -- that the wrapper
adds with ``torch.sum`` over the partial axes: no float atomics, the
same bits every run.  On CPU tensors the Function runs
``ssm_scan_plain`` and ``ssm_scan_bwd_plain``, the reverse recurrence
in PyTorch.
The JAX package has no backward kernel (JAX differentiates the jnp
scan), so this one has no Pallas counterpart.
"""

from __future__ import annotations

import ctypes

import torch

# launches of the CUDA forward kernel by ``ssm_scan`` (and nothing
# else); ``bwd_launches`` those of the backward kernel by
# ``SSMScanFn.backward`` (either dtype), ``bwd_bf16_launches`` those on
# bf16 inputs alone
launches = 0
bwd_launches = 0
bwd_bf16_launches = 0

STATE_SIZES = (4, 8, 16)       # hymba's 16; the JAX kernel tests' 4, 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 12 + [ctypes.c_void_p] * 3)
_SCRATCH_ARGTYPES = [ctypes.c_int] * 5
_BWD_ARGTYPES = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 8
                 + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
_BWD_SIZES_ARGTYPES = [ctypes.c_int] * 6


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


def ssm_scan_bwd_plain(x, dt, b_in, c_out, a_log, h0, dy, dh_end=None):
    """The backward kernel's math in PyTorch, f32: the inputs of
    ``ssm_scan_plain`` and dy (B,S,D), dh_end (B,D,N) or None -> (dx,
    ddt (B,S,D), db, dc (B,S,N), da_log (D,N), dh0 (B,D,N)), all f32.
    The states are recomputed forward, then g_t = C_t dy_t + a_{t+1}
    g_{t+1} runs in reverse from dh_end."""
    a_neg = -torch.exp(a_log.float())
    bsz, s, d = x.shape
    n = b_in.shape[-1]
    xf, dtf = x.float(), dt.float()
    bf, cf, dyf = b_in.float(), c_out.float(), dy.float()
    h = (torch.zeros((bsz, d, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    hs, das = [h], []
    for t in range(s):
        da = torch.exp(dtf[:, t, :, None] * a_neg[None])       # (B,D,N)
        dbx = (dtf[:, t] * xf[:, t])[:, :, None] * bf[:, t, None, :]
        h = da * hs[-1] + dbx  # fedlint: disable=FED003 -- eager PyTorch reference of the kernel, tolerance-gated
        hs.append(h)
        das.append(da)
    g = (torch.zeros((bsz, d, n), dtype=torch.float32, device=x.device)
         if dh_end is None else dh_end.float().clone())
    gs = [None] * s
    for t in range(s - 1, -1, -1):
        g = cf[:, t, None, :] * dyf[:, t, :, None] + g  # fedlint: disable=FED003 -- eager PyTorch reference of the kernel, tolerance-gated
        gs[t] = g
        g = das[t] * g
    G = torch.stack(gs, dim=1)                   # (B,S,D,N): g_t
    H = torch.stack(hs[1:], dim=1)               # h_t
    Hp = torch.stack(hs[:-1], dim=1)             # h_{t-1}
    A = torch.stack(das, dim=1)                  # a_t
    gb = (G * bf[:, :, None, :]).sum(dim=-1)     # (B,S,D)
    dx = dtf * gb
    ddt = xf * gb + (G * Hp * a_neg * A).sum(dim=-1)  # fedlint: disable=FED003 -- eager PyTorch reference of the kernel, tolerance-gated
    db = (G * (dtf * xf)[..., None]).sum(dim=2)
    dc = (H * dyf[..., None]).sum(dim=2)
    da_log = a_neg * (G * Hp * A * dtf[..., None]).sum(dim=(0, 1))
    return dx, ddt, db, dc, da_log, g


def _lib():
    from repro_torch.kernels import _build
    lib = _build.load("ssm_scan")
    if lib.ssm_scan_fwd.argtypes is None:
        lib.ssm_scan_fwd.argtypes = _ARGTYPES
        lib.ssm_scan_fwd.restype = ctypes.c_int
        lib.ssm_scan_scratch.argtypes = _SCRATCH_ARGTYPES
        lib.ssm_scan_scratch.restype = ctypes.c_longlong
    return lib


def _bwd_lib():
    from repro_torch.kernels import _build
    lib = _build.load("ssm_scan_bwd")
    if lib.ssm_scan_bwd.argtypes is None:
        lib.ssm_scan_bwd.argtypes = _BWD_ARGTYPES
        lib.ssm_scan_bwd.restype = ctypes.c_int
        lib.ssm_scan_bwd_sizes.argtypes = _BWD_SIZES_ARGTYPES
        lib.ssm_scan_bwd_sizes.restype = ctypes.c_longlong
    return lib


def _check(x, dt, b_in, c_out, a_log, h0):
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


def _kernel_forward(x, dt, b_in, c_out, a_log, h0):
    """One launch of the forward kernel on CUDA tensors: (y, h_end,
    carries), ``carries`` the chunks' carry-outs of the time split
    (None for S = 1), which the backward kernel reads."""
    global launches
    bsz, s, d = x.shape
    n = b_in.shape[2]
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
    return y, h_end, carries


def time_split(bsz, s, d, n):
    """(segment length, segments a chunk, chunks) of the forward
    kernel's time split of S steps, as its ``ssm_scan_scratch`` reports
    it; for S = 1 (the step kernel, no split) one step in one chunk of
    the backward kernel's segments."""
    if s > 1:
        lib = _lib()
        return tuple(int(lib.ssm_scan_scratch(bsz, s, d, n, which))
                     for which in (2, 3, 4))
    return 1, int(_bwd_lib().ssm_scan_bwd_sizes(bsz, s, d, n, 1, 3)), 1


def _kernel_backward(x, dt, b_in, c_out, a_log, h0, dy, dh_end, carries):
    """One launch of the backward kernel on CUDA tensors (x, dt, b_in,
    c_out f32 or bf16 of one dtype, dy taken in that dtype), then the
    partials summed over their partial axes; the gradients f32.
    ``carries``: what ``_kernel_forward`` returned for the same
    inputs."""
    global bwd_launches, bwd_bf16_launches
    bsz, s, d = x.shape
    n = b_in.shape[2]
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype
                                     for t in (dt, b_in, c_out)):
        raise TypeError(f"ssm_scan backward kernel takes f32 or bf16 x, dt, "
                        f"b_in, c_out of one dtype, got {x.dtype}, "
                        f"{dt.dtype}, {b_in.dtype}, {c_out.dtype}")
    seg, warps, chunks = time_split(bsz, s, d, n)
    lib = _bwd_lib()
    f32 = dict(dtype=torch.float32, device=x.device)
    dy = dy.to(x.dtype).contiguous()
    if dh_end is not None:
        dh_end = dh_end.float().contiguous()

    def size(which):
        return int(lib.ssm_scan_bwd_sizes(bsz, s, d, n, chunks, which))

    groups = size(2)
    dx = torch.empty((bsz, s, d), **f32)
    ddt = torch.empty((bsz, s, d), **f32)
    dbc = torch.empty((bsz, groups, s, 2 * n), **f32)
    da = torch.empty((bsz, chunks, d, n), **f32)
    dh0 = torch.empty((bsz, d, n), **f32)
    # the reverse carries between chunks: zeroed tickets and flags, and
    # the chunks' carry-outs
    sync = torch.zeros(size(0), dtype=torch.int32, device=x.device)
    gcar = torch.empty(size(1), **f32)
    with torch.cuda.device(x.device):
        err = lib.ssm_scan_bwd(
            x.data_ptr(), dt.data_ptr(), b_in.data_ptr(), c_out.data_ptr(),
            a_log.data_ptr(), None if h0 is None else h0.data_ptr(),
            None if carries is None else carries.data_ptr(),
            dy.data_ptr(), None if dh_end is None else dh_end.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), dbc.data_ptr(), da.data_ptr(),
            dh0.data_ptr(), sync.data_ptr(), gcar.data_ptr(),
            _DTYPES[x.dtype], bsz, s, d, n, seg, warps, chunks,
            *x.stride(), *dt.stride(), *b_in.stride(), *c_out.stride(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan_bwd launch failed: CUDA error {err}")
    bwd_launches += 1
    bwd_bf16_launches += x.dtype == torch.bfloat16
    return (dx, ddt, dbc[..., :n].sum(dim=1), dbc[..., n:].sum(dim=1),
            da.sum(dim=(0, 1)), dh0)


class SSMScanFn(torch.autograd.Function):
    """``ssm_scan`` with a gradient: on CUDA tensors the forward and
    backward kernels; on CPU tensors ``ssm_scan_plain`` and
    ``ssm_scan_bwd_plain``.  Returns (y, h_end)."""

    @staticmethod
    def forward(ctx, x, dt, b_in, c_out, a_log, h0):
        carries = None
        if x.device.type == "cuda":
            y, h_end, carries = _kernel_forward(x, dt, b_in, c_out, a_log,
                                                h0)
        else:
            y, h_end = ssm_scan_plain(x, dt, b_in, c_out, a_log, h0)
        ctx.save_for_backward(x, dt, b_in, c_out, a_log, h0, carries)
        ctx.set_materialize_grads(False)
        return y, h_end

    @staticmethod
    def backward(ctx, dy, dh_end):
        x, dt, b_in, c_out, a_log, h0, carries = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        if x.device.type == "cuda":
            dx, ddt, db, dc, da_log, dh0 = _kernel_backward(
                x, dt, b_in, c_out, a_log, h0, dy, dh_end, carries)
        else:
            dx, ddt, db, dc, da_log, dh0 = ssm_scan_bwd_plain(
                x, dt, b_in, c_out, a_log, h0, dy, dh_end)
        return (dx.to(x.dtype), ddt.to(dt.dtype), db.to(b_in.dtype),
                dc.to(c_out.dtype), da_log.to(a_log.dtype),
                None if h0 is None else dh0.to(h0.dtype))


def ssm_scan(x, dt, b_in, c_out, a_log, h0=None):
    """x, dt (B,S,D); b_in, c_out (B,S,N); a_log (D,N) f32; h0 (B,D,N)
    f32 or None -> (y (B,S,D) in x's dtype, h_end (B,D,N) f32).

    On a CUDA tensor this launches the kernel on the current stream and
    does not synchronize: x, dt, b_in, c_out f32 or bf16 of one dtype
    (any strides), N in ``STATE_SIZES``; anything else raises.  On the
    CPU it is ``ssm_scan_plain``.  With grad mode on and an input that
    requires grad it is ``SSMScanFn`` (f32 or bf16 inputs).
    """
    _check(x, dt, b_in, c_out, a_log, h0)
    ins = (x, dt, b_in, c_out, a_log) + (() if h0 is None else (h0,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        return SSMScanFn.apply(x, dt, b_in, c_out, a_log, h0)
    if x.device.type != "cuda":
        return ssm_scan_plain(x, dt, b_in, c_out, a_log, h0)
    return _kernel_forward(x, dt, b_in, c_out, a_log, h0)[:2]
