"""The port's work model on one H100: the kernels' bounds, and a whole
step's dot FLOPs and HBM bytes counted from the config.

(a) The kernels' bounds.  Each ``*_bound_ms`` is the least time the card
could take for one call: the bytes the call must move (each input read
once, each output written once) over the HBM rate, or the operations it
does over the card's peak rate for their type, the larger.  The peaks
are NVIDIA's data-sheet figures for one H100 SXM5:
``HBM_BYTES_PER_S`` and ``BF16_TENSOR_FLOPS_PER_S`` (``H100_SXM``'s
``hbm_bw`` and ``peak_flops``), ``TF32_TENSOR_FLOPS_PER_S`` (dense TF32
on the tensor cores), ``F32_FLOPS_PER_S`` (f32 on the CUDA cores) and
``SFU_EXP_PER_S`` (the special-function units' exp2 rate: 16 a clock an
SM, compute capability 9.0, at the 1.98 GHz boost clock).
``chip_smoke.py`` prints these bounds beside each kernel's time.

(b) ``step_cost(cfg, shape, tcfg)``: the global ``dot_flops`` and
``hbm_bytes`` of one call of the port's ``make_train_step``,
``make_prefill_step`` or ``make_serve_step`` (``launch/steps.py``) at
``shape``, on the card, as arithmetic over the config (no tensors).  It
is the counterpart of the JAX package's HLO roofline
(``analysis.analyze_hlo``) for a port that has no compiler to ask.

Dot FLOPs (2 * m * k * n a product) count:

* every product of every layer kind the configs use: the attention
  projections (wq, wk, wv, wo); the MLP (w_gate, w_up, w_down); the MoE
  router (f32), its experts over the capacity slots the sort-based
  dispatch fills (G groups x E experts x C slots, ``moe.capacity_for``:
  all of them computed, dropped or not) and the combine over each
  token's top k; the SSM's w_in, w_dt, w_bc and w_out; the mLSTM's w_up,
  w_q, w_k, w_v, the f32 gate product w_if, w_down and its chunkwise
  core (per chunk of 256: q.C, q.k^T, (w*qk).v, q.n, the C and n
  updates); the sLSTM's w and its ``h @ R`` for each token; the xLSTM
  block's GeLU MLP; the LM head over the loss's tokens (B*(S-1) causal,
  B*S for an encoder), the last position of a prefill, or each decode
  token.  hubert's frontend is the port's stub: frames enter as the
  embeddings, with no product;
* attention's score and value products, 2 * D flops each a visible
  (q, k) pair of a head, over the pairs the card computes
  (``attention_pairs``): K4's visible pairs (``visible_pairs``) where
  ``models/attention.py: attention`` takes a kernel route, every pair of
  the S x T square where it takes the naive branch; decode's
  ``decode_attention`` over the whole ring cache.  K5's scan is not a
  product (its exps and FMAs are K5's bound, not the step's);
* the backward's two products for each forward product (training),
  less those autograd does not run: a product whose operand is the
  zero initial state (the mLSTM's first chunk, the sLSTM's first token)
  needs one, one whose output nothing reads (the mLSTM's last state
  update) none;
* the recomputation that ``tcfg.remat`` asks for: every block product
  but the block's last (the MLP's w_down, whose output the backward
  never reads: the checkpoint's recompute stops before it) once more
  under ``remat_policy="full"``, the batched ones (attention, the
  experts and the combine, the mLSTM core, the sLSTM's ``h @ R``) under
  ``"dots"``; and the loss's logits once more, always (each loss chunk
  is checkpointed).

HBM bytes count what the eager port must move, as a lower bound: each
product reads its operands and writes its result once in the dtype it
computes in (the model dtype; f32 for the router, the mLSTM gates and
core, the plain attention); K4's and K5's tensors as their bounds below
count them (forward, and the backward pair in training); the embedding
gather; the stacked-gradient fills and adds of a train step (autograd
gives each layer's view of an (L, ...) leaf a full (L, ...) gradient and
adds it in: 4 L-fold leaf passes a layer, ``ROADMAP.md`` queue 2 item
8); the clip's norm (a squared copy read once, 12 B a parameter in f32)
and the optimizer's eager update (``optimizer_bytes_per_param``: 180 B a
parameter for f32 AdamW, ~20 elementwise kernels each a pass over
memory, where one fused pass would move 28 B, queue 2 item 12).
Elementwise work between products (norms, activations, RoPE, softmax,
residual adds) is not counted.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.config.base import InputShape, ModelConfig, TrainConfig
from repro_torch.launch import steps as steps_lib
from repro_torch.models.moe import capacity_for
from repro_torch.models.xlstm import _inner_width
from repro_torch.roofline.analysis import H100_SXM, HWSpec, roofline_terms
from repro_torch.tree import tree_leaves

# Published peaks of one H100 SXM: the yardsticks of ``bound_ms``.
HBM_BYTES_PER_S = H100_SXM.hbm_bw
F32_FLOPS_PER_S = 67e12
BF16_TENSOR_FLOPS_PER_S = H100_SXM.peak_flops
SFU_EXP_PER_S = 16 * 132 * 1.98e9
# dense TF32 on the tensor cores, H100 SXM
TF32_TENSOR_FLOPS_PER_S = 494.7e12
# TF32 products a f32 product in split TF32 (lo.hi + hi.lo + hi.hi)
SPLIT_TF32_PRODUCTS = 3


def _f32_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu()
    return torch.as_tensor(x, dtype=torch.float32)


# ---------------------------------------------------------------------------
# K1-K3: the row sums of kernels/fedagg.py
# ---------------------------------------------------------------------------

def fedagg_bound_ms(weights, p: int):
    """K1: least time for this call: live rows read once, output written
    once, two operations per live element."""
    n_live = int((weights > 0).sum())
    n = weights.numel()
    by_bytes = ((n_live * p + p) * 4 + 2 * n * 4) / HBM_BYTES_PER_S * 1e3
    by_ops = 2 * n_live * p / F32_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def fold_bound_ms(coef, p: int):
    """K2: least time for one folded merge: live rows and the global row
    (when its coefficient is positive) read once, the output written
    once, the coefficients read once; two operations per element read."""
    c = _f32_cpu(coef)
    c = c.clamp(min=0.0).nan_to_num(0.0)
    n_live = int((c[1:] > 0).sum())
    g_read = 1 if float(c[0]) > 0 else 0
    by_bytes = (((n_live + g_read) * p + p) * 4
                + 4 * c.numel()) / HBM_BYTES_PER_S * 1e3
    by_ops = 2 * (n_live + g_read) * p / F32_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def partial_bound_ms(coef, p: int):
    """K3: least time for one shard's partial sum: live rows read once,
    the output written once, the coefficients read once; two operations
    per live element."""
    c = _f32_cpu(coef).nan_to_num(0.0)
    n_live = int((c > 0).sum())
    by_bytes = ((n_live * p + p) * 4 + 4 * c.numel()) / HBM_BYTES_PER_S \
        * 1e3
    by_ops = 2 * n_live * p / F32_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


# ---------------------------------------------------------------------------
# K4: attention
# ---------------------------------------------------------------------------

def visible_pairs(s, t, causal, window, q_offset):
    """(q, k) pairs the masks leave visible, row by row."""
    n = 0
    for p in range(q_offset, q_offset + s):
        lo = max(0, p - window + 1) if window > 0 else 0
        hi = min(t, p + 1) if causal else t
        n += max(0, hi - lo)
    return n


def flash_bound_ms(qs, ks, esize, causal, window, q_offset):
    """K4's forward: least time for one call, the largest of three: 4*D
    flops per visible (q, k) pair per head (two dots) against the bf16
    tensor peak; one exp per visible pair against the SFU's exp2 rate;
    q, k, v read and the output written once against HBM.  Returns (ms,
    "operations" or "bytes", which operations bind ("tensor flops" or
    "exps", or None when bytes bind), flops, exps)."""
    b, s, h, d = qs
    t, hkv = ks[1], ks[2]
    exps = b * h * visible_pairs(s, t, causal, window, q_offset)
    flops = 4 * exps * d
    by_flops = flops / BF16_TENSOR_FLOPS_PER_S * 1e3
    by_exps = exps / SFU_EXP_PER_S * 1e3
    nbytes = (2 * b * s * h * d + 2 * b * t * hkv * d) * esize
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound = max(by_flops, by_exps, by_bytes)
    if bound == by_bytes:
        return bound, "bytes", None, flops, exps
    return bound, "operations", ("tensor flops" if by_flops >= by_exps
                                 else "exps"), flops, exps


def flash_softcap_bound_ms(qs, ks, esize, causal, window, q_offset):
    """K4's serving forward with a logit softcap: ``flash_bound_ms`` with
    two special-function operations a visible pair, the softmax's exp
    and at least the exp inside the score's tanh.  Same return."""
    bound, by, ops, flops, exps = flash_bound_ms(qs, ks, esize, causal,
                                                 window, q_offset)
    by_exps = 2 * exps / SFU_EXP_PER_S * 1e3
    if by_exps <= bound:
        return bound, by, ops, flops, exps
    return by_exps, "operations", "exps", flops, 2 * exps


# special-function operations a visible pair in each of K4's kernels
# with a logit softcap: the exp (the forward's softmax, the backward's
# recomputed P) and at least the exp inside the score's tanh; without a
# cap, the exp alone
SOFTCAP_SFU_PER_PAIR = 2
# those of the capped bf16 kernels' design (csrc/fa_hopper.cuh:
# softcap_r): the tanh's ex2 and rcp, then the exp; each kernel's floor
# beside its bound (the pair recomputes them in both kernels: 6)
SOFTCAP_TC_SFU_PER_PAIR = 3


def sfu_floor_ms(qs, ks, sfu_per_pair, causal=True, window=0, q_offset=0):
    """ms of ``sfu_per_pair`` special-function operations a visible (q, k)
    pair of a head at the SFU's rate (``SFU_EXP_PER_S``): a design's
    floor where those operations bind it."""
    b, s, h, _ = qs
    pairs = b * h * visible_pairs(s, ks[1], causal, window, q_offset)
    return sfu_per_pair * pairs / SFU_EXP_PER_S * 1e3


# The work of K4's backward, per kernel and for the pair, that its bound
# counts: D-long dots a visible (q, k) pair -- dq q.k, dO.v, dS.k; dkdv
# q.k, dO.v, P.dO, dS.q; the pair's function the five distinct ones
# (the kernels recompute q.k and dO.v in both) -- and the q-, kv- and
# row-sized f32 tensors read and written once.
FA_BWD_WORK = (
    ("dq", 3, {"q": 3, "kv": 2, "row": 1}, {"q": 1, "row": 1}),
    ("dkdv", 4, {"q": 2, "kv": 2, "row": 2}, {"kv": 2}),
    ("pair", 5, {"q": 3, "kv": 2, "row": 1}, {"q": 1, "kv": 2}))

# K4's f32 forward with lse: two dots a visible pair (q.k, P.v); q, k, v
# read, the output and lse written
FA_FWD_WORK = (2, {"q": 1, "kv": 2}, {"q": 1, "row": 1})

# The work of K4's bf16 backward, as FA_BWD_WORK counts it, in bf16
# tensors (o and out_lo both read: delta is of their sum) and f32 rows
# (lse, delta); and of its bf16 forward with lse (out, out_lo, lse
# written)
FA_BWD_BF16_WORK = (
    ("dq", 3, {"q": 4, "kv": 2, "row": 1}, {"q": 1, "row": 1}),
    ("dkdv", 4, {"q": 2, "kv": 2, "row": 2}, {"kv": 2}),
    ("pair", 5, {"q": 4, "kv": 2, "row": 1}, {"q": 1, "kv": 2}))
FA_FWD_BF16_WORK = (2, {"q": 1, "kv": 2}, {"q": 2, "row": 1})


def flash_bwd_bound_ms(qs, ks, dots, reads, writes, q_offset=0, causal=True,
                       window=0, sfu_per_pair=1):
    """K4's f32 backward: least time for one kernel (or the pair, or the
    forward): ``dots`` D-long f32 dot products (2*D flops each) and
    ``sfu_per_pair`` special-function operations (one exp; with a
    softcap ``SOFTCAP_SFU_PER_PAIR``) per visible (q, k) pair of a head,
    the f32 tensors it must read
    and write once (``reads``, ``writes``: counts of q-sized, kv-sized
    and row-sized tensors) against HBM, on either of two routes: the
    flops on the CUDA cores (67 TFLOP/s f32), or in split TF32 on the
    tensor cores (three TF32 products a product at 494.7 TFLOP/s); exps
    at the SFU's rate on both.  The bound is the lesser route's.
    Returns a dict: ``ms``, ``by`` ("operations" or "bytes"), ``route``,
    ``flops`` (f32), ``tf32_flops``, ``exps`` (the special-function
    operations), ``cuda_core_ms``, ``tensor_ms``, ``bytes_ms``."""
    b, s, h, d = qs
    t, hkv = ks[1], ks[2]
    pairs = b * h * visible_pairs(s, t, causal, window, q_offset)
    flops = 2 * d * dots * pairs
    tf32_flops = SPLIT_TF32_PRODUCTS * flops
    by_exps = sfu_per_pair * pairs / SFU_EXP_PER_S * 1e3
    sizes = {"q": b * s * h * d, "kv": b * t * hkv * d, "row": b * h * s}
    nbytes = 4 * sum(n * sizes[kind] for kind, n in
                     list(reads.items()) + list(writes.items()))
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    cuda_ops = max(flops / F32_FLOPS_PER_S * 1e3, by_exps)
    tensor_ops = max(tf32_flops / TF32_TENSOR_FLOPS_PER_S * 1e3, by_exps)
    ops, route = min((cuda_ops, "CUDA cores, f32"),
                     (tensor_ops, "tensor cores, split TF32"))
    return {"ms": max(ops, by_bytes),
            "by": "operations" if ops >= by_bytes else "bytes",
            "route": route, "flops": flops, "tf32_flops": tf32_flops,
            "exps": sfu_per_pair * pairs,
            "cuda_core_ms": max(cuda_ops, by_bytes),
            "tensor_ms": max(tensor_ops, by_bytes), "bytes_ms": by_bytes}


def flash_bwd_bf16_bound_ms(qs, ks, dots, reads, writes, causal=True,
                            window=0, sfu_per_pair=1):
    """K4's bf16 training kernels: least time for one kernel (or the
    pair, or the forward with lse): ``dots`` D-long dots (2*D flops
    each) a visible (q, k) pair of a head at the bf16 tensor-core rate,
    ``sfu_per_pair`` special-function operations a pair (one exp; with a
    softcap ``SOFTCAP_SFU_PER_PAIR``) at the SFU's rate, and the bf16 q-
    and kv-sized and f32 row-sized tensors read and written once against
    HBM; the larger."""
    b, s, h, d = qs
    t, hkv = ks[1], ks[2]
    pairs = b * h * visible_pairs(s, t, causal, window, 0)
    flops = 2 * d * dots * pairs
    by_exps = sfu_per_pair * pairs / SFU_EXP_PER_S * 1e3
    esize = {"q": 2, "kv": 2, "row": 4}
    sizes = {"q": b * s * h * d, "kv": b * t * hkv * d, "row": b * h * s}
    nbytes = sum(n * sizes[kind] * esize[kind] for kind, n in
                 list(reads.items()) + list(writes.items()))
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ops = max(flops / BF16_TENSOR_FLOPS_PER_S * 1e3, by_exps)
    return {"ms": max(ops, by_bytes),
            "by": "operations" if ops >= by_bytes else "bytes",
            "flops": flops, "exps": sfu_per_pair * pairs, "bytes": nbytes}


# ---------------------------------------------------------------------------
# K5: the selective scan
# ---------------------------------------------------------------------------

def ssm_bound_ms(b, s, d, n, esize, with_h0):
    """K5's forward: least time for one call: x, dt, B, C read once, y
    written once, a_log (and h0) read and h_end written once, against
    HBM; or the B*S*D*N exps against the SFU rate; whichever is
    larger."""
    nbytes = ssm_bytes(b, s, d, n, esize, with_h0)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = b * s * d * n / SFU_EXP_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def ssm_bytes(b, s, d, n, esize, with_h0):
    """The bytes ``ssm_bound_ms`` counts."""
    return (3 * b * s * d + 2 * b * s * n) * esize + 4 * d * n \
        + 4 * b * d * n * (2 if with_h0 else 1)


def ssm_bwd_bound_ms(b, s, d, n, esize):
    """K5's backward: x, dt, dy read, dx, ddt written (B,S,D); B, C read
    and dB, dC written (B,S,N), in the inputs' element size; a_log read,
    dA_log written (D,N) in f32; or one exp a_t per (t, d, n).  Returns
    (bytes ms, exps ms)."""
    by_bytes = ssm_bwd_bytes(b, s, d, n, esize) / HBM_BYTES_PER_S * 1e3
    by_ops = b * s * d * n / SFU_EXP_PER_S * 1e3
    return by_bytes, by_ops


def ssm_bwd_bytes(b, s, d, n, esize):
    """The bytes ``ssm_bwd_bound_ms`` counts."""
    return esize * (5 * b * s * d + 4 * b * s * n) + 4 * 2 * d * n


# ---------------------------------------------------------------------------
# A whole step: dot FLOPs and HBM bytes from the config
# ---------------------------------------------------------------------------

def _esize(tcfg: TrainConfig) -> int:
    return {"bfloat16": 2, "float32": 4}[tcfg.dtype]


def _eager_pass_bytes(esize: int):
    """(reads, writes) of each eager op of ``update_in_place`` on one
    parameter element for AdamW with weight decay and a clip scale, and
    of the clip's norm: the gradient and parameter in ``esize`` bytes,
    moments and temporaries in f32.  Returns (optimizer bytes, clip
    bytes) a parameter."""
    up = 0 if esize == 4 else 1            # a .float() / .to() that copies
    f = 4
    ops = [
        # clip scale: g.float() * scale, cast back
        (up * esize, up * f), (f, f), (up * f, up * esize),
        # m = b1*m + (1-b1)*g.float()
        (f, f), (up * esize, up * f), (f, f), (2 * f, f),
        # v = b2*v + (1-b2)*square(g.float())
        (f, f), (up * esize, up * f), (f, f), (f, f), (2 * f, f),
        # u = -lr*(m/bc1) / (sqrt(v/bc2) + eps) - lr*wd*p.float()
        (f, f), (f, f), (f, f), (f, f), (f, f), (2 * f, f),
        (up * esize, up * f), (f, f), (2 * f, f),
        # apply_updates: (p.float() + u).to(p.dtype)
        (up * esize, up * f), (2 * f, f), (up * f, up * esize),
        # the three copy_ into p, m, v
        (esize, esize), (f, f), (f, f),
    ]
    opt = sum(r + w for r, w in ops)
    clip = up * (esize + f) + f + f + f     # g.float(), square, sum
    return opt, clip


def optimizer_bytes_per_param(tcfg: TrainConfig) -> int:
    """Bytes a parameter the eager clip + AdamW update moves (180 + 12
    for f32 parameters); a fused single pass would read g, p, m, v and
    write p, m, v: 28 B in f32."""
    opt, clip = _eager_pass_bytes(_esize(tcfg))
    return opt + clip


def attention_pairs(s, t, causal, window, chunk_q, chunk_kv):
    """(q, k) pairs of one (batch row, head) whose two products the card
    computes in ``models/attention.py: attention``: the whole S x T
    square on the naive branch (``s * t <= 256 * 256`` or chunks that do
    not divide), K4's visible pairs on every other branch."""
    if s * t <= 256 * 256 or s % min(chunk_q, s) or t % min(chunk_kv, t):
        return s * t
    return visible_pairs(s, t, causal, window, 0)


@dataclasses.dataclass
class _Product:
    name: str
    flops: float          # one forward execution, all layers
    nbytes: float
    batched: bool         # a bmm: recomputed under remat_policy="dots"
    last: bool = False    # the block's last product: never recomputed
    # the backward's flops, where autograd runs fewer than its two
    # products (a constant operand, an output nothing reads)
    bwd: Optional[float] = None

    @property
    def bwd_flops(self) -> float:
        return 2.0 * self.flops if self.bwd is None else self.bwd


def _mm(name, m, k, n, e, layers=1, batched=False, nb=1):
    """``m`` rows of k against ``nb`` distinct (k, n) right operands (a
    bmm's batch; 1 for a weight), ``layers`` times."""
    return _Product(name, 2.0 * m * k * n * layers,
                    float((m * k + nb * k * n + m * n) * e * layers), batched)


def _block_products(cfg: ModelConfig, b: int, s: int, kind: str,
                    tcfg: TrainConfig, pairs: Callable, kv_len: int,
                    window: int) -> Tuple[List[_Product], Dict]:
    """The products of every block, each summed over the stacked layers,
    and the kernels' forward tensors."""
    e = _esize(tcfg)
    t = b * s                          # tokens through the block
    d = cfg.d_model
    out: List[_Product] = []
    kern = {"k4_pairs": 0, "k4_calls": 0, "k5_calls": 0}
    if cfg.family == "ssm":
        n_pairs = cfg.num_layers // 2
        h = cfg.n_heads
        di = _inner_width(d, h, cfg.proj_factor)
        dh = di // h
        out += [_mm("mlstm.w_up", t, d, 2 * di, e, n_pairs),
                _mm("mlstm.w_q", t, di, di, e, n_pairs),
                _mm("mlstm.w_k", t, di, di, e, n_pairs),
                _mm("mlstm.w_v", t, di, di, e, n_pairs),
                _mm("mlstm.w_if", t, di, 2 * h, 4, n_pairs),
                _mm("mlstm.w_down", t, di, d, e, n_pairs)]
        qc = 1 if kind == "decode" else min(256, s)
        if s % qc:
            qc = s
        nc = s // qc
        bh = b * h * nc * n_pairs
        core = [_mm("mlstm.core.qC", bh * qc, dh, dh, 4, batched=True, nb=bh),
                _mm("mlstm.core.qk", bh * qc, dh, qc, 4, batched=True, nb=bh),
                _mm("mlstm.core.wqk_v", bh * qc, qc, dh, 4, batched=True,
                    nb=bh),
                _mm("mlstm.core.qn", bh * qc, dh, 1, 4, batched=True, nb=bh),
                _mm("mlstm.core.C_update", bh * dh, qc, dh, 4, batched=True,
                    nb=bh),
                _mm("mlstm.core.n_update", bh, qc, dh, 4, batched=True, nb=bh)]
        # autograd's backward: the first chunk's q.C and q.n meet the
        # zero initial state (no gradient: one product each), the last
        # chunk's state updates feed nothing (no product)
        for p in core[:4:3]:
            p.bwd = 2.0 * p.flops - p.flops / nc
        for p in core[4:]:
            p.bwd = 2.0 * p.flops * (nc - 1) / nc
        h_r = _mm("slstm.hR", t * h, d // h, 4 * (d // h), e, n_pairs,
                  batched=True, nb=h)
        h_r.bwd = 2.0 * h_r.flops - h_r.flops / s   # token 0: h0 = 0
        out += core + [_mm("slstm.w", t, d, 4 * d, e, n_pairs), h_r]
        out += _mlp_products("mlp", t, d, int(d * 4 / 3), "gelu", e, n_pairs)
        return out, kern
    L = cfg.num_layers
    q_dim, kv_dim, hd = cfg.q_dim, cfg.kv_dim, cfg.head_dim
    out += [_mm("attn.wq", t, d, q_dim, e, L),
            _mm("attn.wk", t, d, kv_dim, e, L),
            _mm("attn.wv", t, d, kv_dim, e, L),
            _mm("attn.wo", t, q_dim, d, e, L)]
    if kind == "decode":
        # decode_attention: f32 einsums over the whole ring cache, k/v
        # repeated to the H heads
        bh = b * cfg.n_heads * L
        out += [_mm("attn.scores", bh, hd, kv_len, 4, batched=True, nb=bh),
                _mm("attn.values", bh, kv_len, hd, 4, batched=True, nb=bh)]
    else:
        n_pairs = pairs(s, s, cfg.causal, window, tcfg.attn_chunk_q,
                        tcfg.attn_chunk_kv)
        bh = b * cfg.n_heads * L
        # the products' flops over the pairs; their bytes are the
        # kernel's tensors (``_kernel_bytes``)
        out += [_Product("attn.scores", 2.0 * bh * n_pairs * hd, 0.0, True),
                _Product("attn.values", 2.0 * bh * n_pairs * hd, 0.0, True)]
        kern["k4_pairs"] = bh * n_pairs
        kern["k4_calls"] = L
    if cfg.family == "moe":
        k, n_e = cfg.top_k, cfg.n_experts
        g = 0 if kind == "decode" else tcfg.moe_group_tokens
        g = g or s
        if t % g:
            g = t
        cap = capacity_for(g, k, n_e, cfg.moe_capacity_factor)
        slots = (t // g) * n_e * cap
        ff = cfg.d_ff
        out.append(_mm("moe.router", t, d, n_e, 4, L))
        names = (("w_gate", "w_up") if cfg.activation == "swiglu"
                 else ("w_up",))
        out += [_mm(f"moe.{w}", slots, d, ff, e, L, batched=True, nb=n_e)
                for w in names]
        out += [_mm("moe.w_down", slots, ff, d, e, L, batched=True, nb=n_e),
                _mm("moe.combine", t, k, d, e, L, batched=True, nb=t)]
        if cfg.moe_dense_residual:
            out += _mlp_products("moe.dense_mlp", t, d,
                                 cfg.moe_dense_ff or cfg.d_ff,
                                 cfg.activation, e, L)
    else:
        out += _mlp_products("mlp", t, d, cfg.d_ff, cfg.activation, e, L)
    if cfg.family == "hybrid":
        di = cfg.ssm_expand * d
        n = cfg.ssm_state
        out += [_mm("ssm.w_in", t, d, 2 * di, e, L),
                _mm("ssm.w_dt", t, di, di, e, L),
                _mm("ssm.w_bc", t, di, 2 * n, e, L),
                _mm("ssm.w_out", t, di, d, e, L)]
        kern["k5_calls"] = L
    return out, kern


def _mlp_products(prefix, t, d, ff, activation, e, layers):
    """An MLP's products; its w_down ends the block (``last``): nothing
    in the block's backward reads its output."""
    names = (("w_gate", "w_up") if activation == "swiglu" else ("w_up",))
    down = _mm(f"{prefix}.w_down", t, ff, d, e, layers)
    down.last = True
    return [_mm(f"{prefix}.{w}", t, d, ff, e, layers) for w in names] + [down]


def step_cost(cfg: ModelConfig, shape: InputShape,
              tcfg: TrainConfig = TrainConfig(), *,
              pairs: Optional[Callable] = None) -> Dict:
    """Global dot FLOPs and HBM bytes of one step of the port at
    ``shape`` (``shape.kind``: "train", "prefill" or "decode"), counted
    as the module docstring says.  ``pairs(s, t, causal, window,
    chunk_q, chunk_kv)`` gives the attention pairs a (batch row, head)
    computes (default ``attention_pairs``, the card's routes).

    Returns ``dot_flops``, ``hbm_bytes``, ``forward_flops`` (one
    forward's products), ``attention_flops`` (the forward's score and
    value products), ``terms`` (each product's forward flops over all
    layers), ``skipped_backward_flops`` (the backward products
    autograd does not run where a scanned backward would: the mLSTM's
    zero initial state and last state update, the sLSTM's first
    token), ``params``, ``optimizer_bytes`` and ``kernel`` (K4's
    visible pairs and launches a forward, K5's launches)."""
    pairs = pairs or attention_pairs
    kind = shape.kind
    b = shape.global_batch
    s = 1 if kind == "decode" else shape.seq_len
    e = _esize(tcfg)
    d, v = cfg.d_model, cfg.vocab_size
    window = cfg.sliding_window
    kv_len = shape.seq_len
    if kind == "decode":
        w = steps_lib.swa_window_for(cfg, shape, enabled=tcfg.long_ctx_swa)
        w = cfg.sliding_window if w < 0 else w
        kv_len = min(shape.seq_len, w) if w > 0 else shape.seq_len
    blocks, kern = _block_products(cfg, b, s, kind, tcfg, pairs, kv_len,
                                   window)
    if kind == "train":
        head_tokens = b * (s if cfg.is_encoder_only else s - 1)
    else:
        head_tokens = b            # the last position / the new token
    head = _mm("head", head_tokens, d, v, e)
    products = blocks + [head]

    fwd = sum(p.flops for p in products)
    attn = sum(p.flops for p in blocks
               if p.name in ("attn.scores", "attn.values"))
    dot = fwd
    nbytes = sum(p.nbytes for p in products)
    params = steps_lib.abstract_params(cfg, tcfg)
    n_params = sum(x.numel() for x in tree_leaves(params))
    opt_bytes = 0
    skipped = 0.0
    if kind == "train":
        bwd = sum(p.bwd_flops for p in products)
        skipped = 2 * fwd - bwd
        dot += bwd + head.flops
        nbytes += 2 * sum(p.nbytes for p in products) + head.nbytes
        if tcfg.remat:
            # the recompute stops once it has remade what the block's
            # backward reads (``torch.utils.checkpoint``'s early stop, as
            # XLA drops the same work): the block's last product is not
            # remade
            redo = [p for p in blocks if not p.last and (
                tcfg.remat_policy != "dots" or p.batched)]
            dot += sum(p.flops for p in redo)
            nbytes += sum(p.nbytes for p in redo)
        opt_bytes = optimizer_bytes_per_param(tcfg) * n_params
        nbytes += opt_bytes
        nbytes += _stacked_grad_bytes(cfg, params)
    nbytes += _kernel_bytes(cfg, b, s, kind, tcfg, kern)
    if not cfg.is_encoder_only:
        nbytes += 2 * b * s * d * e          # the embedding gather
    return {"dot_flops": dot, "hbm_bytes": nbytes,
            "forward_flops": fwd, "attention_flops": attn,
            "terms": {p.name: p.flops for p in products},
            "skipped_backward_flops": skipped,
            "params": n_params, "optimizer_bytes": opt_bytes,
            "kernel": kern}


def _stacked_grad_bytes(cfg: ModelConfig, params) -> float:
    """A train step's stacked-gradient traffic: each layer's view of an
    (L, ...) leaf gets a full (L, ...) gradient (zero-filled, its slice
    written) that is then added into the leaf's gradient (two read, one
    written): 4 passes over the whole leaf a layer.  ``params`` is the
    abstract (``meta``) tree."""
    n_stack = cfg.num_layers // 2 if cfg.family == "ssm" else cfg.num_layers
    return float(sum(4 * n_stack * leaf.numel() * leaf.element_size()
                     for leaf in tree_leaves(params["blocks"])))


def _kernel_bytes(cfg, b, s, kind, tcfg, kern) -> float:
    """K4's and K5's tensors, as their bounds count them: each forward
    (with lse in training; once more when ``tcfg.remat`` recomputes the
    block, under either policy: neither kernel is a saved product) and,
    in training, the backward pair."""
    e = _esize(tcfg)
    redo = 1 if (kind == "train" and tcfg.remat) else 0
    total = 0.0
    if kern["k4_calls"]:
        sizes = {"q": b * s * cfg.q_dim, "kv": b * s * cfg.kv_dim,
                 "row": b * cfg.n_heads * s}
        esz = {"q": e, "kv": e, "row": 4}

        def work(reads, writes):
            return sum(n * sizes[k] * esz[k] for k, n in
                       list(reads.items()) + list(writes.items()))

        if kind == "train":
            fwd = FA_FWD_WORK if e == 4 else FA_FWD_BF16_WORK
            bwd = FA_BWD_WORK if e == 4 else FA_BWD_BF16_WORK
            one = (1 + redo) * work(*fwd[1:]) + work(*bwd[-1][2:])
        else:
            one = work({"q": 1, "kv": 2}, {"q": 1})
        total += one * kern["k4_calls"]
    if kern["k5_calls"]:
        di = cfg.ssm_expand * cfg.d_model
        n = cfg.ssm_state
        one = ssm_bytes(b, s, di, n, e, kind == "decode")
        if kind == "train":
            one = one * (1 + redo) + ssm_bwd_bytes(b, s, di, n, e)
        total += one * kern["k5_calls"]
    return float(total)


# ---------------------------------------------------------------------------
# Roofline of a step
# ---------------------------------------------------------------------------

ROOFLINE_BASIS = (
    "step_cost: dot FLOPs and HBM bytes of the port's eager step counted "
    "from the config (roofline/cost.py); per chip = global / chips (the "
    "port has no SPMD partitioner); collective_s 0: no collective runs "
    "on one card")


def step_roofline(cfg: ModelConfig, shape: InputShape,
                  tcfg: TrainConfig = TrainConfig(), *, chips: int = 1,
                  hw: HWSpec = H100_SXM) -> Dict:
    """The reference's roofline record (``compute_s``, ``memory_s``,
    ``collective_s``, ``dominant``, ``bound_s``, ``model_flops_global``,
    ``hlo_flops_global``, ``useful_ratio``) from ``step_cost`` on ``hw``;
    the global counts divided by ``chips``."""
    cost = step_cost(cfg, shape, tcfg)
    terms = roofline_terms(hlo_flops=cost["dot_flops"],
                           hbm_bytes=cost["hbm_bytes"], collective_bytes=0.0,
                           chips=chips, hw=hw)
    mf = steps_lib.model_flops(cfg, shape)
    terms["model_flops_global"] = mf
    terms["hlo_flops_global"] = cost["dot_flops"]
    terms["useful_ratio"] = mf / max(cost["dot_flops"], 1.0)
    terms["hbm_bytes_global"] = cost["hbm_bytes"]
    return terms


def step_share(cfg: ModelConfig, shape: InputShape, tcfg: TrainConfig,
               s_step: float, hw: HWSpec = H100_SXM) -> Dict:
    """A timed step against its cost on one card: ``bound_s`` and what
    binds it, ``mfu`` = model FLOPs / (s_step * peak), and
    ``bound_s / s_step``."""
    r = step_roofline(cfg, shape, tcfg, chips=1, hw=hw)
    return {"hw": hw.name, "bound_s": r["bound_s"], "dominant": r["dominant"],
            "compute_s": r["compute_s"], "memory_s": r["memory_s"],
            "dot_flops": r["hlo_flops_global"],
            "hbm_bytes": r["hbm_bytes_global"],
            "model_flops": r["model_flops_global"],
            "mfu": r["model_flops_global"] / (s_step * hw.peak_flops),
            "bound_over_step": r["bound_s"] / s_step}


__all__ = ["step_cost", "step_roofline", "step_share", "attention_pairs",
           "visible_pairs", "fedagg_bound_ms", "fold_bound_ms",
           "partial_bound_ms", "flash_bound_ms", "flash_bwd_bound_ms",
           "flash_bwd_bf16_bound_ms", "sfu_floor_ms", "ssm_bound_ms",
           "ssm_bwd_bound_ms", "optimizer_bytes_per_param"]
