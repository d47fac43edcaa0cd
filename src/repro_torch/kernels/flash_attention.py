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
reference.  The output is in q's dtype.  ``D`` is 64 (hymba, llama),
80 (hubert), 128 (mixtral, arctic, phi4-mini, granite, chameleon), 192
(nemotron), or 16 or 32 (the JAX kernel tests' shapes); any other ``D``
raises ``ValueError``.
``S`` and ``T`` need not be tile multiples.

The dtype picks one of two kernels (neither is a fallback of the
other):

* f32 -> the split-TF32 kernel: ``mma.sync`` TF32 products on the
  tensor cores with each f32 operand split in two (x = hi + lo, each
  part rounded to nearest TF32, ``csrc/tf32_split.cuh``, the split the
  backward pair shares; three TF32 products a product, about 2^-21
  relative of either sign: one TF32 product fails the tolerance;
  ``split_tf32_plain`` and ``split_dot_plain`` model it), the score
  product's three TF32 products summed from zero a k-step and added in
  f32 (the tensor cores' chained sums round toward zero), each tile's
  P.V product summed from zero and added
  in f32, K/V tiles of 64 keys in a 2-stage ``cp.async`` ring, ``expf``
  and a true divide as the reference; checked at rtol = atol = 2e-5.
  Up to D = 64 q's split fragments sit in shared memory, each thread's
  own; at D = 80, 128 and 192 the q tile does and a block is eight
  warps, the two of a pair sharing 16 q rows: each computes S over half
  of a key tile, the pair agrees on the row max and trades P through
  shared memory, and each takes P.V over half of the output columns
  (``csrc/flash_attention.cu``; ``fwd_sizes`` reports each launch).
  Its k and v must sit on 16-byte addresses with 16-byte strides
  (``cp.async``), or the call raises ``ValueError``.
* bf16 -> the tensor-core kernel: ``wgmma`` for ``Q.K^T`` and ``P.V``,
  K/V tiles of 128 keys fed by TMA into a 3-stage ring with
  ``mbarrier``s by a producer warp, two consumer warpgroups of 64 q
  rows each (a CTA owns 128 rows) that take turns at the tensor cores
  and run a tile's softmax under the previous tile's ``P.V``, 24
  registers for the producer and 240 for the consumers
  (``setmaxnreg``).  It takes the unnormalised ``P`` into ``P.V`` as
  two bf16 parts (``P`` to about 2^-16, as the reference's f32 ``P``)
  and exp through ``exp2`` (``ex2.approx``): checked at rtol 8e-3,
  atol 1e-3 against the f32 plain version.  At D = 128 and 192 the
  tiles are stored in swizzled blocks of 64 columns and the output is
  staged in the q tile's space (128-key tiles in 3 stages at 128,
  96-key tiles in 2 at 192); at D = 80 (a 160-byte row, not a multiple
  of the 128-byte swizzle) in five blocks of 16 columns in the 32-byte
  swizzle, P.V one ``m64n80k16``.  Its q, k
  and v must sit on 16-byte addresses with 16-byte strides (TMA's
  rule), or the call raises ``ValueError``.

Bound: per visible (q, k) pair of a head, ``4*D`` flops on the tensor
cores (989e12 flop/s in bf16; in f32 three TF32 products at 494.7e12)
and one exp on the special-function units (16 a clock an SM:
4.18e12/s) -- in bf16 at D=64 the two are within 8 % of each other --
against bytes (q, k, v, out once) two orders lower.

Logit softcap (``softcap > 0``): ``s = cap * tanh(s / cap)`` on the
scaled score, before the masks, as the reference's jnp attention
(``repro/models/attention.py: _softcap``; its Pallas kernel has none).
Every kernel takes it: the ``CAP`` instantiations of the two forwards
are built in their own translation unit,
``csrc/flash_attention_softcap.cu`` (one a head dim and dtype, which
writes lse -- and in bf16 ``out_lo`` -- only when asked), and those of
the two backward pairs in ``csrc/flash_attention_bwd_softcap.cu`` and
``csrc/flash_attention_bwd_tc_softcap.cu``, each linked into its
kernels' library, so the instantiations without a cap compile as
before.  The backward recomputes the capped score with the forward's
tanh (so P matches the lse the forward wrote), and dS takes the cap's
derivative: ``dS = P * (dP - delta) * (1 - tanh^2)``.  The f32 kernels
take the accurate ``tanhf``; the three bf16 ones a branch-free tanh of
one ``ex2`` and one ``rcp`` (``csrc/fa_hopper.cuh: softcap_r``, modelled
by ``softcap_log2_model``).

A CUDA tensor goes to a kernel or the call raises;
``flash_attention_plain`` (the function of
``repro/kernels/ref.py: flash_attention_ref``, heads folded into the
batch) serves CPU tensors and the checks that hold both kernels
against it.

Gradients.  When grad mode is on and q, k or v requires grad,
``flash_attention`` goes through ``FlashAttentionFn``: its forward is
the forward kernel of the dtype asked also for each row's log-sum-exp
``lse`` (B,H,S) f32 (no bit of the output changes), its backward the
two kernels of that dtype (``flash_attention_bwd_dq_f32`` / ``_bf16``,
which also writes ``delta = rowsum(dO * O)``, then
``flash_attention_bwd_dkdv_f32`` / ``_bf16``, dk and dv summed over each
kv head's group in registers; no float atomics, so gradients are the
same bits every run).  f32: ``csrc/flash_attention_bwd.cu``, products
on the tensor cores in split TF32 (three TF32 products a product, about
2^-19 relative at worst), tiles by 16-byte ``cp.async``; at D = 80, 128
and 192 a block is eight warps, the two of a pair sharing 16 stationary
rows, each computing S and dP over half of the moving tile and passing
P and dS to the other through shared memory.  bf16:
``csrc/flash_attention_bwd_tc.cu``, warp-specialised blocks of a TMA
producer and two ``wgmma`` consumer warpgroups of 64 stationary rows (dq:
q rows, K/V tiles moving; dkdv: keys, (q tile, head) items moving), P
and dS as two bf16 parts each into the second products (one part misses
the bf16 tolerance), lse, delta and the sums f32, the gradients rounded
once to bf16; the bf16 forward asked for lse also writes ``out_lo``,
what the rounding of its output left, and delta is taken of out +
out_lo (of out alone it would be off by 2^-9, enough to fail the bf16
tolerance in dq and dk).  q, k, v, o (and out_lo) and dO must sit on
16-byte addresses with 16-byte strides (``cp.async``; TMA), or the
backward raises ``ValueError`` before either launch.  ``bwd_sizes``
reports each launch.  On CPU tensors the Function runs the plain forward and
``flash_attention_bwd_plain``, the same math in PyTorch, in f32 for
either dtype (the gradients then rounded to the inputs' dtype).
The JAX package has no backward kernel (JAX differentiates the jnp
attention), so these have no Pallas counterpart.
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG = -1e30

# launches of either CUDA forward kernel by ``flash_attention`` (and
# nothing else); ``tc_launches`` those of the tensor-core (bf16) kernel
# alone; ``bwd_dq_launches`` and ``bwd_dkdv_launches`` those of the two
# backward kernels (either dtype) by ``FlashAttentionFn.backward``, the
# ``_bf16`` ones those of the bf16 pair alone
launches = 0
tc_launches = 0
bwd_dq_launches = 0
bwd_dkdv_launches = 0
bwd_dq_bf16_launches = 0
bwd_dkdv_bf16_launches = 0
# those of the forward kernels with a logit softcap (either dtype), and
# of the backward kernels with one (dq and dkdv, either dtype)
softcap_launches = 0
softcap_bwd_launches = 0

HEAD_DIMS = (16, 32, 64, 80, 128, 192)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 3
             + [ctypes.c_float] + [ctypes.c_void_p] * 3 + [ctypes.c_float])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_float])
# the bf16 dq entry takes o_lo after o
_BWD_DQ_BF16_ARGTYPES = [ctypes.c_void_p] + _BWD_ARGTYPES
# the backward pair's entries by dtype: (dq, dkdv)
_BWD_ENTRIES = {torch.float32: ("flash_attention_bwd_dq_f32",
                                "flash_attention_bwd_dkdv_f32"),
                torch.bfloat16: ("flash_attention_bwd_dq_bf16",
                                 "flash_attention_bwd_dkdv_bf16")}


def _mask(s: int, t: int, causal: bool, window: int, q_offset: int,
          device):
    """(S,T) bool: key j visible to row i (absolute positions)."""
    qp = torch.arange(s, device=device) + q_offset
    kp = torch.arange(t, device=device)
    m = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        m &= kp[None, :] <= qp[:, None]
    if window > 0:
        m &= kp[None, :] > qp[:, None] - window
    return m


def softcap_scores(s_, softcap: float):
    """``cap * tanh(s / cap)`` as the reference writes it (divide, tanh,
    multiply), or ``s`` when ``softcap`` is 0."""
    return torch.tanh(s_ / softcap) * softcap if softcap > 0 else s_


def softcap_log2_model(s_, scale: float, softcap: float, *,
                       ex2_err: float = 0.0, rcp_err: float = 0.0):
    """The capped bf16 kernels' arithmetic (``csrc/fa_hopper.cuh:
    softcap_r``) on raw scores ``s_`` (before the scale), in f32 with
    the host's f32 constants ``k2 = 2 log2(e) scale / cap`` and
    ``cap_log2 = cap log2(e)``: ``r = 1 / (1 + 2^(s k2))`` and the capped
    score in the log2 domain, ``fmaf(-2 cap_log2, r, cap_log2)`` (``cap
    log2(e) tanh(s scale / cap)``; one rounding, as the FFMA).  Returns
    (capped score, r); ``4 r (1 - r)`` is the backward's ``1 - tanh^2``.
    ``ex2_err`` and ``rcp_err`` scale the two special-function results by
    ``1 + err``: the approximations' relative error, for the tests that
    bound the design.  Used by tests only: the wrappers' plain twins
    compute ``torch.tanh``."""
    k2 = torch.tensor(2.0 * math.log2(math.e) * scale / softcap,
                      dtype=torch.float32)
    cap_log2 = torch.tensor(softcap * math.log2(math.e), dtype=torch.float32)
    e = torch.exp2(s_.float() * k2) * (1.0 + ex2_err)
    r = (1.0 / (1.0 + e)) * (1.0 + rcp_err)
    # the FFMA: the f32 product exact in f64, one rounding of the sum
    capped = torch.addcmul(cap_log2.double(), r.double(), cap_log2.double(),
                           value=-2.0).float()
    return capped, r


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          q_offset: int = 0, softcap: float = 0.0):
    """q (BH,S,D), k/v (BH,T,D), heads folded into the batch -> (BH,S,D)
    in q's dtype: the materialised f32 softmax of ``ref.py:
    flash_attention_ref``, the scores soft-capped before the masks when
    ``softcap > 0``."""
    d = q.shape[-1]
    s_ = torch.einsum("bsd,btd->bst", q.float(), k.float()) / math.sqrt(d)
    s_ = softcap_scores(s_, softcap)
    m = _mask(q.shape[1], k.shape[1], causal, window, q_offset, q.device)
    s_ = torch.where(m[None], s_, torch.full((), NEG, device=q.device))
    p = torch.softmax(s_, dim=-1)
    return torch.einsum("bst,btd->bsd", p, v.float()).to(q.dtype)


def gqa_plain(q, k, v, *, causal: bool = True, window: int = 0,
              q_offset: int = 0, softcap: float = 0.0):
    """Model layout through the plain version: k/v repeated per group,
    heads folded into the batch (the reference's ``ops.py:
    gqa_flash_attention``)."""
    b, s, h, d = q.shape
    kx, vx = repeat_kv_heads(k, h), repeat_kv_heads(v, h)

    def fold(t):
        return t.movedim(2, 1).reshape(b * h, t.shape[1], d)

    o = flash_attention_plain(fold(q), fold(kx), fold(vx), causal=causal,
                              window=window, q_offset=q_offset,
                              softcap=softcap)
    return o.reshape(b, h, s, d).movedim(1, 2)


def _bits(x):
    """The f32 tensor's bit patterns as int64 in [0, 2^32)."""
    return x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _from_bits(u):
    """Bit patterns in [0, 2^32) (int64) -> the f32 values they encode."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(
        torch.int32).view(torch.float32)


def split_tf32_plain(x):
    """``csrc/tf32_split.cuh: tf32_split`` on an f32 tensor -> (hi, lo),
    each a TF32 value (its 13 low bits clear) rounded to nearest, ties
    away from zero: hi = x + half a TF32 ulp, masked; lo the same of
    x - hi, clamped first below the card's NaN (0x7fffffff, which the
    card's subtraction gives for any NaN) so that a NaN stays one.
    |x - hi - lo| <= 2^-22 |x| for finite x.  For the tests and tools:
    the kernels split on the card."""
    x = x.float()
    hi = _from_bits((_bits(x) + 0x1000) & 0xFFFFE000)
    rest = x - hi
    rest = torch.where(torch.isnan(rest),
                       _from_bits(torch.tensor(0x7FFFFFFF)), rest)
    r = _bits(rest)
    r = torch.where(r >= 1 << 31, r - (1 << 32), r)        # as the int
    r = torch.clamp(r, max=0x7FFFEFFF) & 0xFFFFFFFF
    return hi, _from_bits((r + 0x1000) & 0xFFFFE000)


def split_dot_plain(a, b, split=split_tf32_plain):
    """``a @ b`` of f32 matrices as the f32 kernels take a product on the
    tensor cores: each operand split by ``split`` (hi, lo), lo.hi +
    hi.lo + hi.hi (lo.lo dropped), each TF32 product exact in f32 and
    the sums in f32.  For the tests and tools."""
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def tma_misalignment(t) -> str:
    """Why ``t`` (a (B,T,H,D) view) cannot be a TMA source, nor one of
    the f32 kernels' 16-byte ``cp.async`` copies, or ``""``: its
    address and its byte strides of batch, position and head must be
    multiples of 16."""
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


# the library of each dtype's backward pair: the split-TF32 kernels, or
# the bf16 ``wgmma`` ones
_BWD_SOURCES = {torch.float32: "flash_attention_bwd",
                torch.bfloat16: "flash_attention_bwd_tc"}


def _bwd_lib(dtype=torch.float32):
    """The built library of ``dtype``'s backward pair, its entries
    typed."""
    from repro_torch.kernels import _build
    lib = _build.load(_BWD_SOURCES[dtype])
    for name in _BWD_ENTRIES[dtype]:
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = (_BWD_DQ_BF16_ARGTYPES
                           if name == "flash_attention_bwd_dq_bf16"
                           else _BWD_ARGTYPES)
            fn.restype = ctypes.c_int
    return lib


# what ``flash_attention_bwd_sizes`` reports of a launch, by its ``which``
BWD_SIZES = ("warps", "shared_bytes", "tile_rows", "stages", "grid_y",
             "dots_a_pair")


def bwd_sizes(d: int, dtype=torch.float32) -> dict:
    """The backward kernels' launch at head dim ``d`` for ``dtype`` as
    the built library of that dtype reports it: ``{"dq": {...}, "dkdv":
    {...}}``, each the warps a block, dynamic shared bytes, rows of a
    moving tile (keys in dq, q rows in dkdv), ring stages, grid y and
    the D-long dots it computes a visible (q, k) pair.  Builds the
    library (a card machine's ``nvcc``)."""
    lib = _bwd_lib(dtype)
    sizes = (lib.flash_attention_bwd_sizes if dtype == torch.float32
             else lib.flash_attention_bwd_tc_sizes)
    if sizes.argtypes is None:
        sizes.argtypes = [ctypes.c_int] * 3
        sizes.restype = ctypes.c_longlong
    return {kind: {key: int(sizes(d, kernel, which))
                   for which, key in enumerate(BWD_SIZES)}
            for kernel, kind in enumerate(("dq", "dkdv"))}


# what ``flash_attention_fwd_sizes`` reports of a launch, by its ``which``
FWD_SIZES = ("warps", "shared_bytes", "tile_keys", "stages", "dots_a_pair")


def fwd_sizes(d: int, dtype) -> dict:
    """The forward kernel's launch at head dim ``d`` for ``dtype``
    (float32: the split-TF32 kernel; bfloat16: the ``wgmma`` one) as the
    built library reports it: warps a block, dynamic shared bytes, keys
    a K/V tile, ring stages and the D-long dots it computes a visible
    (q, k) pair.  Both kernels launch one block a (q tile, head,
    batch).  Builds the library (a card machine's ``nvcc``)."""
    sizes = _lib().flash_attention_fwd_sizes
    if sizes.argtypes is None:
        sizes.argtypes = [ctypes.c_int] * 3
        sizes.restype = ctypes.c_longlong
    return {key: int(sizes(d, _DTYPES[dtype], which))
            for which, key in enumerate(FWD_SIZES)}


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(
            f"flash_attention: q (B,S,H,D) and k, v (B,T,Hkv,D) with "
            f"H % Hkv == 0 expected, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")


def _kernel_forward(q, k, v, causal, window, q_offset, with_lse,
                    softcap=0.0):
    """One launch of the forward kernel on CUDA tensors; returns (out,
    lse, out_lo), the last two None without ``with_lse``.  ``with_lse``
    also writes each row's log-sum-exp (B,H,S) f32 for the backward and,
    in bf16, ``out_lo`` (B,S,H,D) bf16, what the rounding of out left
    (out + out_lo is the f32 output to about 2^-16: the backward's
    delta reads both); out_lo is None in f32.  ``softcap > 0`` takes the
    cap's instantiation (lse then that of the capped scores)."""
    global launches, tc_launches, softcap_launches
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes f32 or bf16 q, k, "
                        f"v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head_dim {d} not in "
                         f"{HEAD_DIMS}: the CUDA kernels are instantiated "
                         f"at these head dims only")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention kernel takes a unit stride on D")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}")
    if s < 1 or t < 1 or q_offset < 0:
        raise ValueError(f"flash_attention kernel: S={s}, T={t}, "
                         f"q_offset={q_offset}")
    if not (math.isfinite(softcap) and softcap >= 0):
        raise ValueError(f"flash_attention kernel: softcap {softcap} (a "
                         "finite cap >= 0)")
    tensor_cores = q.dtype == torch.bfloat16
    copied = ((("q", q), ("k", k), ("v", v)) if tensor_cores
              else (("k", k), ("v", v)))
    route = "bf16 kernel (TMA)" if tensor_cores else "f32 kernel (cp.async)"
    for name, x in copied:
        why = tma_misalignment(x)
        if why:
            raise ValueError(f"flash_attention {route}: {name} {why}")
    lib = _lib()
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    out_lo = torch.empty_like(out) if with_lse and tensor_cores else None
    with torch.cuda.device(q.device):      # the launch goes to q's card
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, s, t, h, hkv, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(bool(causal)), int(window), int(q_offset),
            1.0 / math.sqrt(d), torch.cuda.current_stream(q.device)
            .cuda_stream, None if lse is None else lse.data_ptr(),
            None if out_lo is None else out_lo.data_ptr(), float(softcap))
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err}")
    launches += 1
    tc_launches += tensor_cores
    softcap_launches += softcap > 0
    return out, lse, out_lo


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True,
                              window: int = 0, q_offset: int = 0,
                              softcap: float = 0.0):
    """``gqa_plain`` and each row's log-sum-exp (B,H,S) f32 of the
    masked (soft-capped) scores (masked scores at -1e30, as the
    kernel's)."""
    b, s, h, d = q.shape
    kx = repeat_kv_heads(k, h).float()
    scores = torch.einsum("bshd,bthd->bhst", q.float(), kx) / math.sqrt(d)
    scores = softcap_scores(scores, softcap)
    m = _mask(s, k.shape[1], causal, window, q_offset, q.device)
    scores = torch.where(m, scores, torch.full((), NEG, device=q.device))
    return (gqa_plain(q, k, v, causal=causal, window=window,
                      q_offset=q_offset, softcap=softcap),
            torch.logsumexp(scores, dim=-1))


def _plain_forward_for_grad(q, k, v, causal, window, q_offset,
                            softcap=0.0):
    """What ``_kernel_forward(..., with_lse=True)`` returns, in PyTorch:
    (out, lse, out_lo), out_lo the rest of out's rounding to bf16 (None
    in f32)."""
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              softcap=softcap)
    if q.dtype != torch.bfloat16:
        return (*flash_attention_fwd_plain(q, k, v, **kw), None)
    full, lse = flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                          **kw)
    out = full.to(q.dtype)
    return out, lse, (full - out.float()).to(q.dtype)


def repeat_kv_heads(k, n_heads: int):
    """(B,T,Hkv,D) -> (B,T,H,D): kv head j serves q heads j*rep ..."""
    return torch.repeat_interleave(k, n_heads // k.shape[2], dim=2)


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: int = 0, q_offset: int = 0,
                              softcap: float = 0.0):
    """The backward kernels' math in PyTorch, f32: q, o, do (B,S,H,D),
    k, v (B,T,Hkv,D), lse (B,H,S) -> (dq, dk, dv) in f32, dk and dv
    summed over each kv head's group of q heads.  P is recomputed from
    lse; a row that sees no key has P = 1/T on every key and dS = 0
    (what autograd of the plain forward gives through its select).  With
    ``softcap > 0`` P is of the capped score ``c = cap * t``, ``t =
    tanh(s / cap)``, and dS carries the cap's derivative ``1 - t^2``."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    scale = 1.0 / math.sqrt(d)
    qf, of, dof = (x.float().movedim(2, 1) for x in (q, o, do))
    kf = repeat_kv_heads(k, h).float().movedim(2, 1)      # (B,H,T,D)
    vf = repeat_kv_heads(v, h).float().movedim(2, 1)
    m = _mask(s, t, causal, window, q_offset, q.device)
    empty = ~m.any(dim=-1)                                # (S,)
    scores = torch.einsum("bhsd,bhtd->bhst", qf, kf) * scale
    if softcap > 0:
        t_ = torch.tanh(scores / softcap)
        scores = t_ * softcap
    p = torch.exp(torch.where(m, scores - lse.float()[..., None],
                              torch.full((), -math.inf, device=q.device)))
    p = torch.where(empty[:, None], torch.full((), 1.0 / t,
                                               device=q.device), p)
    delta = (dof * of).sum(dim=-1)                        # (B,H,S)
    dp = torch.einsum("bhsd,bhtd->bhst", dof, vf)
    ds = torch.where(m, p * (dp - delta[..., None]),
                     torch.zeros((), device=q.device))
    if softcap > 0:
        ds = ds * (1.0 - t_.square())
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kf) * scale
    dk = torch.einsum("bhst,bhsd->bhtd", ds, qf) * scale
    dv = torch.einsum("bhst,bhsd->bhtd", p, dof)

    def group_sum(x):                         # (B,H,T,D) -> (B,T,Hkv,D)
        return x.reshape(b, hkv, rep, t, d).sum(dim=2).movedim(1, 2)

    return dq.movedim(1, 2), group_sum(dk), group_sum(dv)


def _kernel_backward(q, k, v, o, lse, do, causal, window, q_offset,
                     o_lo=None, softcap=0.0):
    """The two backward launches on CUDA tensors of q's dtype (f32 or
    bf16; dO taken in that dtype): dq (and delta) first, then dk and dv,
    in q's dtype.  bf16 takes ``o_lo`` too, the forward's (delta is of o
    + o_lo).  ``softcap > 0`` takes the cap's instantiations (lse is
    then the capped forward's).  A misaligned input raises
    ``ValueError`` before either launch."""
    global bwd_dq_launches, bwd_dkdv_launches, softcap_bwd_launches
    global bwd_dq_bf16_launches, bwd_dkdv_bf16_launches
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if q.dtype not in _BWD_ENTRIES or any(x.dtype != q.dtype
                                          for x in (k, v, o)):
        raise TypeError(f"flash_attention backward kernels take f32 or "
                        f"bf16 q, k, v, o of one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}, {o.dtype}")
    bf16 = q.dtype == torch.bfloat16
    if bf16 != (o_lo is not None):
        raise ValueError("flash_attention backward kernels: o_lo goes with "
                         "bf16 inputs, and only with them")
    if not (math.isfinite(softcap) and softcap >= 0):
        raise ValueError(f"flash_attention backward kernels: softcap "
                         f"{softcap} (a finite cap >= 0)")
    q, k, v, o, do = (x.contiguous() for x in (q, k, v, o,
                                               do.to(q.dtype)))
    named = [("q", q), ("k", k), ("v", v), ("o", o), ("do", do)]
    if bf16:
        o_lo = o_lo.contiguous()
        named.append(("o_lo", o_lo))
    for name, x in named:
        why = tma_misalignment(x)
        if why:
            raise ValueError(f"flash_attention backward kernels "
                             f"({'TMA' if bf16 else 'cp.async'}): {name} "
                             f"{why}")
    lib = _bwd_lib(q.dtype)
    dq_entry, dkdv_entry = (getattr(lib, name)
                            for name in _BWD_ENTRIES[q.dtype])
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    shape = (b, s, t, h, hkv, d, int(bool(causal)), int(window),
             int(q_offset), 1.0 / math.sqrt(d))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = dq_entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            *((o_lo.data_ptr(),) if bf16 else ()),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *shape, stream, float(softcap))
        if err != 0:
            raise RuntimeError(f"{_BWD_ENTRIES[q.dtype][0]} launch failed: "
                               f"CUDA error {err}")
        bwd_dq_launches += 1
        bwd_dq_bf16_launches += bf16
        softcap_bwd_launches += softcap > 0
        err = dkdv_entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *shape, stream, float(softcap))
    if err != 0:
        raise RuntimeError(f"{_BWD_ENTRIES[q.dtype][1]} launch failed: "
                           f"CUDA error {err}")
    bwd_dkdv_launches += 1
    bwd_dkdv_bf16_launches += bf16
    softcap_bwd_launches += softcap > 0
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with a gradient: on CUDA tensors the forward
    kernel of the inputs' dtype (asked for lse) and the two backward
    kernels of that dtype; on CPU tensors the plain forward and
    ``flash_attention_bwd_plain``.  The softcap (0: none) rides in
    ``ctx.masks`` beside the masks."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, softcap=0.0):
        if q.device.type == "cuda":
            out, lse, out_lo = _kernel_forward(q, k, v, causal, window,
                                               q_offset, with_lse=True,
                                               softcap=softcap)
        else:
            out, lse, out_lo = _plain_forward_for_grad(q, k, v, causal,
                                                       window, q_offset,
                                                       softcap)
        ctx.save_for_backward(q, k, v, out, lse, out_lo)
        ctx.masks = (causal, window, q_offset, softcap)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, out_lo = ctx.saved_tensors
        causal, window, q_offset, softcap = ctx.masks
        if q.device.type == "cuda":
            dq, dk, dv = _kernel_backward(q, k, v, out, lse, do, causal,
                                          window, q_offset, out_lo, softcap)
        else:
            o = out if out_lo is None else out.float() + out_lo.float()
            dq, dk, dv = flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal=causal, window=window,
                q_offset=q_offset, softcap=softcap)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, softcap: float = 0.0):
    """q (B,S,H,D); k/v (B,T,Hkv,D) with H a multiple of Hkv ->
    (B,S,H,D) in q's dtype.

    On a CUDA tensor this launches a kernel on the current stream and
    does not synchronize: the split-TF32 kernel for f32, the ``wgmma``
    kernel for bf16 (q, k and v of one dtype), a unit stride on D, D in
    ``HEAD_DIMS``, and 16-byte aligned addresses and strides (k and v
    for f32; q, k and v for bf16); anything else raises.  On the CPU it
    is ``gqa_plain``.  With grad mode on and an input that requires
    grad it is ``FlashAttentionFn`` (f32 or bf16).  ``softcap > 0`` caps
    the scores (``cap * tanh(s / cap)``) before the masks, with or
    without a gradient.
    """
    _check(q, k, v)
    if _needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, bool(causal), int(window),
                                      int(q_offset), float(softcap))
    if q.device.type != "cuda":
        return gqa_plain(q, k, v, causal=causal, window=window,
                         q_offset=q_offset, softcap=softcap)
    return _kernel_forward(q, k, v, causal, window, q_offset,
                           with_lse=False, softcap=softcap)[0]
