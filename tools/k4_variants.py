#!/usr/bin/env python3
"""Variants of the bf16 attention kernel (K4) on one GPU, timed in turns.

    python3 tools/k4_variants.py [--only v0,bq192,...] [--prefill]
                                 [--shapes narrow|wide|all|capped]
                                 [--scaled]
                                 [--baseline NAME=FILE.cu ...]

Each variant is the committed ``src/repro_torch/kernels/csrc/
flash_attention.cu`` with text patches and ``-D`` switches, built with
``nvcc -Xptxas -v`` into ``build/k4_variants/`` (registers and spills are
printed); each ``--baseline NAME=FILE.cu`` adds another source of the
same entry point (an earlier commit's kernel, say) as the variant NAME,
unpatched.  The variants that compute attention are held against
``gqa_plain`` on the edge cases of ``chip_smoke.py``, at the bf16
tolerance (rtol 8e-3, atol 1e-3; ``p_single``, which rounds P to bf16
once, at its own atol 3e-3); the ablations (parts switched off) only
run.  All are timed with ``chip_smoke.median_ms`` (launches enqueued
behind other device work, so the reading is device time) at the
prefill shapes of ``chip_smoke.py`` (``--shapes``: the three at head
dim 64, the four at 128 and 192 -- mixtral, phi4-mini, arctic,
nemotron -- or all), in turns: v0 first, then each variant, then the
order reversed.  With ``--prefill``, each checked variant also runs
``chip_smoke.bf16_prefill_vs_f32`` (the bf16 hymba 1280-token prefill,
with the variant and with ``gqa_plain``, against the f32 forward on the
same weights).  The last line of standard output is one JSON object of
the times.  Needs one CUDA card and nvcc; exits non-zero otherwise or
when a checked variant disagrees.  The ``serial`` consumer and the
192-row block keep the head-dim-64 tiling (128-key tiles, one 64-column
block): those variants are checked and timed at D <= 64 only.  The
others, ``WIDE`` below, also run ``chip_smoke.WIDE_HEAD_CASES`` and the
wide shapes.  v0, the f32 variants and the capped ones (``CAPPED``) are
built with their own softcap instantiations (``flash_attention_softcap.cu``'s
launches appended to the variant's text); every other source gets a
stub that refuses a cap.  With ``--shapes capped`` every variant of
the committed consumer (``WIDE``, the ablations too) carries them, and
v0 and those that compute attention are also held to
``chip_smoke.check_softcap`` on
``softcap_checks``' bf16 cases, and timed at llama3.2-1b's layers with a
cap of 50 (``CAP_SHAPES``: the serving forward at 2 x 4096, the forward
with lse at 2 x 2048) beside the layer without a cap.
With ``--scaled``, v0 and each f32 variant of the split (``SPLIT_OF``)
run ``tools/k4_bwd_variants.py``'s scaled mode: the forward and the
backward pair built together with the same split, the capped forward on
normal q x 1 and x 100 at llama3.2-1b's serving layer and the gradients
at its training layer against the f32 twin and an f64 answer
(``chip_smoke._scaled_q_errors``), the forward with lse and the pair
timed in turns at the training layers.

Variants:
  v0                  the committed kernel (softmax under the previous
                      tile's P.V, ping-pong turns between the two
                      consumer warpgroups, P.V with P split in two bf16
                      parts)
  p_single            v0 with P rounded to bf16 once (one P.V product)
  serial              a warpgroup's tile in series, no turns (the
                      kernel's first design)
  serial_tree4        serial, four partial row maxima and sums
  overlap             v0 without the turns
  pingpong_branching  v0 whose last turn branches (ptxas: C7520)
  all_lanes           every lane arrives on the empty barriers
  serial_bq192        serial at 192 rows (three consumer warpgroups)
  overlap_bq192       overlap at 192 rows
  stages4             a 4-stage K/V ring
  l2_256              256-byte L2 promotion on the tensor maps
  multicast           (D = 128, 192) clusters of two heads sharing each
                      K/V tile by TMA multicast
  multicast_loads_only
                      (ablation) loads_only on the multicast clusters
  remote_arrivals     multicast, each stage freed by the consumer warps'
                      arrivals on both CTAs' barriers (no handshake)
  remote_arrivals_no_mc
                      those barriers, each CTA loading its own tiles
  no_multicast        (D = 128, 192) those clusters, each CTA loading its
                      own K/V tiles
  depth2              (D = 128) a 2-stage K/V ring
  tanhf               the capped bf16 forward as PR 33 wrote it: the
                      accurate tanhf in place of fa_hopper.cuh's softcap_r
                      (one ex2, one rcp), and cap_turns
  cap_turns           the capped kernel with the ping-pong turns (v0:
                      the kernels without a cap only)
  fma_exp             the capped softmax's exponent on the FMA pipe for
                      every second element (a Cody-Waite split and a
                      polynomial), the SFU's ex2 for the rest
  fma_exp_quarter     the same for every fourth element
  rescale_under_qk    o's rescale under the issued Q.K^T, inside the turn
  keys64              (D = 192) 64-key tiles in a 3-stage ring
  f32_keys32          the f32 kernel at D = 192 on 32-key tiles
  f32_unroll4         the f32 kernel above D = 64, S's k-steps unrolled 4
                      (v0: 2; 4 spill beside its two score sums)
  f32_rna             hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi) (v0:
                      csrc/tf32_split.cuh, both rounded to nearest by an
                      integer add and a mask)
  f32_rnahi           hi rounded to nearest by an integer add before the
                      mask, lo = x - hi passed whole (of either sign)
  no_softmax          (ablation) products, no softmax
  no_products         (ablation) softmax on stale scores, no products
  loads_only          (ablation) the TMA ring and barriers alone
  loads_only_bq192    (ablation) the same at 192 rows
  NAME                a source given with --baseline NAME=FILE.cu
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "k4_variants"
TOL = (8e-3, 1e-3)
# P rounded to bf16 once: a second rounding beside the output's
TOL_P_SINGLE = (8e-3, 3e-3)
# name -> (b, s, h, hkv, window, d): the prefill layers of
# chip_smoke.py, head dim 64, then 128 and 192
SHAPES = {"hymba-4096-window1024": (2, 4096, 25, 5, 1024, 64),
          "hymba-1024-causal": (2, 1024, 25, 5, 0, 64),
          "llama-4096-causal": (2, 4096, 32, 8, 0, 64)}
WIDE_SHAPES = {"mixtral-4096-window4096": (2, 4096, 32, 8, 4096, 128),
               "phi4-mini-4096-causal": (2, 4096, 24, 8, 0, 128),
               "arctic-2048-causal": (1, 2048, 56, 8, 0, 128),
               "nemotron-4096-causal": (1, 4096, 96, 8, 0, 192)}
# the f32 kernel (with lse) at the training layers of chip_smoke.py's
# FA_BWD_SHAPES with head dims 128 and 192
F32_SHAPES = {"phi4-mini-2048-causal-f32": (1, 2048, 24, 8, 0, 128),
              "nemotron-2048-causal-f32": (1, 2048, 96, 8, 0, 192)}
TOL_F32 = (2e-5, 2e-5)
# llama3.2-1b's layers with Gemma 2's cap of 50 (chip_smoke.py:
# SOFTCAP_PREFILL, SOFTCAP_TRAIN), bf16, causal: the serving forward and
# the forward with lse; name -> (b, s, h, hkv, d, cap, with lse)
CAP_SHAPES = {"llama-4096-causal-cap50": (2, 4096, 32, 8, 64, 50.0, False),
              "llama-2048-causal-cap50-lse": (2, 2048, 32, 8, 64, 50.0,
                                              True)}


def replace(src, old, new):
    if src.count(old) != 1:
        raise SystemExit(f"k4_variants: patch anchor not found once: "
                         f"{old[:60]!r}")
    return src.replace(old, new)


def between(src, start, end, new):
    """``src`` with the text from ``start`` (inclusive) up to ``end``
    (kept) replaced by ``new``."""
    i = src.index(start)
    j = src.index(end, i)
    return src[:i] + new + src[j:]


# -- the patches ---------------------------------------------------------

def knobs(src):
    """FA_NWG consumer warpgroups (64 rows each), FA_STAGES, FA_L2_256.
    The turns are for two consumer warpgroups: FA_NWG=3 goes with
    ``serial`` or ``no_turns``."""
    src = replace(src, """constexpr int BQ = 128;          // q rows a CTA: two consumer warpgroups
constexpr int BK = 128;          // keys a K/V tile
constexpr int STAGES = 3;        // depth of the K/V ring
constexpr int THREADS = 384;     // producer warpgroup + 2 consumers
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;""", """#ifndef FA_NWG
#define FA_NWG 2
#endif
#ifndef FA_STAGES
#define FA_STAGES 3
#endif
constexpr int NWG = FA_NWG;
constexpr int BQ = 64 * NWG;
constexpr int BK = 128;
constexpr int STAGES = FA_STAGES;
constexpr int THREADS = 128 * (NWG + 1);
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = NWG == 2 ? 240 : 160;""")
    src = replace(src, """            mbar_init(empty_k(st), 8);     // lane 0 of each consumer warp
            mbar_init(empty_v(st), 8);""", """            mbar_init(empty_k(st), 4 * NWG);
            mbar_init(empty_v(st), 4 * NWG);""")
    # the tensor maps' L2 promotion (fa_hopper.cuh's FA_TMA_L2)
    return replace(src, '#include "fa_hopper.cuh"',
                   "#ifdef FA_L2_256\n"
                   "#define FA_TMA_L2 CU_TENSOR_MAP_L2_PROMOTION_L2_256B\n"
                   '#endif\n#include "fa_hopper.cuh"')


# the ping-pong's turn barriers (the kernels without a cap take them)
TURN_BEGIN = """            if constexpr (!CAP)
                asm volatile("bar.sync %0, 256;\\n" :: "r"(3 + w)
                             : "memory");"""
TURN_END = """            if constexpr (!CAP)
                asm volatile("bar.arrive %0, 256;\\n" :: "r"(4 - w)
                             : "memory");"""
TURN_FIRST = """        if (!CAP && w == 1)
            asm volatile("bar.arrive 3, 256;\\n" ::: "memory");"""
TURN_LAST = """        if (!CAP && w == 0)
            asm volatile("bar.sync 3, 256;\\n" ::: "memory");"""


def no_turns(src):
    """Overlap without ping-pong: the turn barriers go."""
    for anchor in (TURN_BEGIN, TURN_END, TURN_FIRST):
        src = replace(src, anchor, "")
    return replace(src, TURN_LAST, "")


def cap_turns(src):
    """The capped kernel with the ping-pong turns, as the kernels without
    a cap (and PR 33's capped kernel) take them."""
    for anchor in (TURN_BEGIN, TURN_END):
        src = replace(src, anchor, anchor.replace(
            "            if constexpr (!CAP)\n    ", ""))
    for anchor in (TURN_FIRST, TURN_LAST):
        src = replace(src, anchor, anchor.replace("!CAP && ", ""))
    return src


def branching_turns(src):
    """Ping-pong whose last turn of warpgroup 1 skips its arrival (a
    branch between issue and wait; ptxas serializes: C7520)."""
    src = replace(src, """        auto turn_end = [&]() {
""" + TURN_END + """
        };""", """        const int n_turns = n_tiles + 1;
        int turn = 0;
        auto turn_end = [&]() {
            if (!CAP && !(w == 1 && turn == n_turns - 1))
                asm volatile("bar.arrive %0, 256;\\n" :: "r"(4 - w)
                             : "memory");
            ++turn;
        };""")
    return replace(src, TURN_LAST, "")


def all_lanes(src):
    """Every lane arrives on the empty barriers (no lane-0 branch)."""
    src = replace(src, """            mbar_init(empty_k(st), 8);     // lane 0 of each consumer warp
            mbar_init(empty_v(st), 8);""", """            mbar_init(empty_k(st), 256);
            mbar_init(empty_v(st), 256);""")
    n = src.count("if (lane == 0) mbar_arrive(")
    if n != 4:
        raise SystemExit(f"k4_variants: {n} lane-0 arrivals, expected 4")
    src = src.replace("if (lane == 0) mbar_arrive(", "mbar_arrive(")
    return replace(src, """            if (lane == 0) {
                mbar_arrive(empty_k(st));
                mbar_arrive(empty_v(st));
            }""", """            mbar_arrive(empty_k(st));
            mbar_arrive(empty_v(st));""")


def ablations(src):
    """ABL_NOQK, ABL_NOPV, ABL_NOSOFTMAX switch parts off (the pipeline
    and its barriers stay)."""
    src = replace(src, """            const uint32_t s_k = s_base + L::K_OFF + st * L::KV_BYTES;
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
                wgmma_qk(
                    s, desc_q + (uint64_t)(L::kstep(kk, BQ) >> 4),
                    make_desc(s_k + L::kstep(kk, BK), 16, L::ATOM,
                              L::SWIZZLE),
                    kk > 0);""", """            const uint32_t s_k = s_base + L::K_OFF + st * L::KV_BYTES;
#ifndef ABL_NOQK
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
                wgmma_qk(
                    s, desc_q + (uint64_t)(L::kstep(kk, BQ) >> 4),
                    make_desc(s_k + L::kstep(kk, BK), 16, L::ATOM,
                              L::SWIZZLE),
                    kk > 0);
#endif""")
    src = replace(src, """            const uint32_t s_v = s_base + L::V_OFF + st * L::KV_BYTES;
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                const uint64_t desc_v = make_desc(s_v + kk * 16 * L::ROW,
                                                  L::ATOM, L::ATOM,
                                                  L::SWIZZLE);
                wgmma_pv<D>(o, pf[kk], desc_v);
                wgmma_pv<D>(o, pf_lo[kk], desc_v);
            }""", """            const uint32_t s_v = s_base + L::V_OFF + st * L::KV_BYTES;
#ifndef ABL_NOPV
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                const uint64_t desc_v = make_desc(s_v + kk * 16 * L::ROW,
                                                  L::ATOM, L::ATOM,
                                                  L::SWIZZLE);
                wgmma_pv<D>(o, pf[kk], desc_v);
                wgmma_pv<D>(o, pf_lo[kk], desc_v);
            }
#endif""")
    return replace(src, """            if (interior)
                softmax_tile<false, BK / 2, CAP>(s, m, l, corr, scale_log2,
                                                 t0, T, row_pos, causal,
                                                 window, k2, cap_log2);
            else
                softmax_tile<true, BK / 2, CAP>(s, m, l, corr, scale_log2,
                                                t0, T, row_pos, causal,
                                                window, k2, cap_log2);
        };""", """#ifndef ABL_NOSOFTMAX
            if (interior)
                softmax_tile<false, BK / 2, CAP>(s, m, l, corr, scale_log2,
                                                 t0, T, row_pos, causal,
                                                 window, k2, cap_log2);
            else
                softmax_tile<true, BK / 2, CAP>(s, m, l, corr, scale_log2,
                                                t0, T, row_pos, causal,
                                                window, k2, cap_log2);
#endif
        };""")


CONSUMER_SERIAL = r"""        float o[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
        float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
        float s[64];

        const uint64_t desc_q = make_desc(s_q + w * 64 * L::ROW, 16,
                                          L::ATOM, L::SWIZZLE);
        mbar_wait(bar, 0);
        for (int j = 0; j < n_tiles; ++j) {
            const int st = j % STAGES;
            const int ph = (j / STAGES) & 1;
            const int t0 = tile_lo + j * BK;
            if (n_rows <= 0
                    || (!wg_blind && (t0 >= w_hi || t0 + BK <= w_lo))) {
                // nothing of this tile is seen by these rows.  It is
                // released only once it has landed: an arrival for a
                // later round of the stage must not count towards this
                // one, whose other warpgroup may still be reading.
                mbar_wait(full_k(st), ph);
                mbar_wait(full_v(st), ph);
                if (lane == 0) {
                    mbar_arrive(empty_k(st));
                    mbar_arrive(empty_v(st));
                }
                continue;
            }
            // S = Q . K^T (64 x 128), K-major operands from the ring
            const uint32_t s_k = s_base + L::K_OFF + st * L::KV_BYTES;
            mbar_wait(full_k(st), ph);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
                wgmma_m64n128k16_ss(
                    s, desc_q + (uint64_t)((32 * kk) >> 4),
                    make_desc(s_k + 32 * kk, 16, L::ATOM, L::SWIZZLE),
                    kk > 0);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(s);
            if (lane == 0) mbar_arrive(empty_k(st));

            // a tile needs the masks unless every key is real and seen
            // by every one of the 64 rows
            const bool interior = t0 + BK <= T
                                  && (!causal || t0 + BK - 1 <= pa)
                                  && (window <= 0 || t0 >= pb - window + 1);
            float corr[2];
            if (interior)
                softmax_tile<false>(s, m, l, corr, scale_log2, t0, T,
                                    row_pos, causal, window);
            else
                softmax_tile<true>(s, m, l, corr, scale_log2, t0, T,
                                   row_pos, causal, window);
            rescale<D>(o, corr);

            // O += P . V: P in two bf16 parts in registers is the A
            // operand (the accumulator's layout is the A fragment's);
            // V (keys x D, D contiguous) is an MN-major B operand
            uint32_t pa_hi[BK / 16][4], pa_lo[BK / 16][4];
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    split_bf16(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1],
                               pa_hi[kk][q], pa_lo[kk][q]);
            const uint32_t s_v = s_base + L::V_OFF + st * L::KV_BYTES;
            mbar_wait(full_v(st), ph);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                const uint64_t desc_v = make_desc(s_v + kk * 16 * L::ROW,
                                                  L::ATOM, L::ATOM,
                                                  L::SWIZZLE);
                wgmma_pv<D>(o, pa_hi[kk], desc_v);
                wgmma_pv<D>(o, pa_lo[kk], desc_v);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(o);
            if (lane == 0) mbar_arrive(empty_v(st));
        }

"""


def serial(src):
    """The kernel's first design: a warpgroup's tile in series (Q.K^T,
    wait, softmax, P.V, wait), no turns."""
    return between(src, "        float o[D / 2];\n#pragma unroll\n"
                        "        for (int i = 0; i < D / 2; ++i) o[i] = 0.f;",
                   "        if (n_rows > 0) {\n"
                   "            // out = o / max(l, 1e-30)", CONSUMER_SERIAL)


SOFTMAX_TREE = r"""// One warpgroup's 64 rows against one 128-key tile (FA_NA partial row
// maxima and sums)
#ifndef FA_NA
#define FA_NA 1
#endif
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             float scale_log2, int t0, int T,
                                             int row_pos, int causal,
                                             int window) {
    const int lane = threadIdx.x & 31;
    float mx[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int a = 0; a < 4; ++a) mx[r][a] = -INFINITY;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
        const int r = (i >> 1) & 1, a = (i >> 2) & (FA_NA - 1);
        if (MASK) {
            const int key = t0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
            const int p = row_pos + 8 * r;
            const bool real = key < T;
            const bool vis = real && (!causal || key <= p)
                             && (window <= 0 || key > p - window);
            s[i] = vis ? s[i] * scale_log2 : (real ? NEG : -INFINITY);
        }
        mx[r][a] = fmaxf(mx[r][a], s[i]);
    }
    float m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        // unmasked scores are still raw: scale > 0 commutes with max
        m_new[r] = fmaxf(m[r], MASK ? x : x * scale_log2);
        corr[r] = ex2(m[r] - m_new[r]);
        m[r] = m_new[r];
    }
    float sum[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int a = 0; a < 4; ++a) sum[r][a] = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
        const int r = (i >> 1) & 1, a = (i >> 2) & (FA_NA - 1);
        s[i] = MASK ? ex2(s[i] - m_new[r])
                    : ex2(fmaf(s[i], scale_log2, -m_new[r]));
        sum[r][a] += s[i];
    }
    // l stays a per-thread partial sum until the epilogue
#pragma unroll
    for (int r = 0; r < 2; ++r)
        l[r] = l[r] * corr[r]
               + ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
}

"""


def tree(src):
    """softmax_tile with FA_NA partial row maxima and sums."""
    return between(src, "// One warpgroup's 64 rows against one tile of N/2 keys",
                   "template <int D>\n__device__ __forceinline__ void rescale(",
                   SOFTMAX_TREE)


def single_p(src):
    """P rounded to bf16 once, one P.V product (the kernel before the
    split): the low part is formed and left unused."""
    return replace(src, """                wgmma_pv<D>(o, pf_lo[kk], desc_v);
""", "")


# The cluster path of ``multicast``: the kernel's bf16 forward at D = 128
# and 192 with K/V tiles shared by a 2-CTA cluster through TMA multicast
# (measured slower on an H100 and not in the kernel: PERF.md).
MC_HELPERS = r"""// The same box into the shared memory of every CTA of the cluster in
// ``mask`` (bit r: the CTA of rank r), at the same offset, completion
// counted on each one's barrier at the offset of ``bar``.
__device__ __forceinline__ void tma_load_4d_mc(uint32_t dst,
                                               const CUtensorMap* map,
                                               uint32_t bar, int c0, int c1,
                                               int c2, int c3,
                                               uint16_t mask) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1, {%4, %5, %6, %7}], [%2], %3;\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "h"(mask), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// An arrival on the barrier at the offset of ``bar`` in the CTA of rank
// ``rank`` of the cluster when ``on`` (a predicate, not a branch),
// releasing this thread's earlier accesses at cluster scope.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar,
                                                   uint32_t rank, int on) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b32 ra;\nsetp.ne.b32 p, %2, 0;\n"
        "@p mapa.shared::cluster.u32 ra, %0, %1;\n"
        "@p mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n}\n"
        :: "r"(bar), "r"(rank), "r"(on) : "memory");
}

// mbar_wait that acquires at cluster scope: for a barrier that the other
// CTA of the cluster arrives on.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, int parity) {
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

// Every thread of both CTAs of the cluster: arrive, then wait.
__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release;\n"
                 "barrier.cluster.wait.acquire;\n" ::: "memory");
}

"""

MC_HEADS = r"""    // CLUSTER: the CTAs of a cluster are heads h and h ^ 1 (grid y is H
    // rounded up to even; a head h >= H has no rows).  Their rows have
    // the same positions, so they walk the same tiles; when both read
    // one kv head, each K/V tile is loaded once for both (mcast), else
    // each CTA loads its own.  The same value in both CTAs.
    const uint32_t rank = blockIdx.y & 1;
    const int mcast = L::CLUSTER && (h | 1) < H
                      && (h & ~1) / (H / Hkv) == (h | 1) / (H / Hkv);

"""

MC_SYNC = r"""    if constexpr (L::CLUSTER) {
        // the barriers of both CTAs are initialised before either
        // multicasts into the other or arrives on its barriers
        cluster_sync();
        if (h >= H) {         // a padding head: only the exit's barrier
            cluster_sync();
            return;
        }
    } else {
        __syncthreads();
    }
"""

MC_PRODUCER = r"""                if constexpr (L::CLUSTER) {
                    // a tile in two halves of HALF rows a 64-column
                    // block: with mcast this CTA loads half ``rank`` into
                    // both CTAs, else both halves into its own.  With
                    // mcast a stage is refilled once the readers of both
                    // CTAs have freed it: each producer, seeing its own
                    // readers done (empty), tells the other (an arrival
                    // on its peer barrier) and waits to be told.  The
                    // handshake is the producers'; the consumers'
                    // arrivals stay local (remote arrivals from their
                    // warps made the kernel ~1.5x slower on an H100:
                    // PERF.md)
                    auto handshake = [&](uint32_t peer) {
                        if (!mcast) return;
                        mbar_arrive_remote(peer, rank ^ 1, j >= STAGES);
                        mbar_wait_cluster(peer, ph ^ 1);
                    };
                    const int h_lo = mcast ? (int)rank : 0;
                    const int h_hi = mcast ? (int)rank + 1 : 2;
                    auto load = [&](uint32_t off, const CUtensorMap* map,
                                    uint32_t full) {
                        for (int c = 0; c < D / L::COLS; ++c)
                            for (int hh = h_lo; hh < h_hi; ++hh) {
                                const uint32_t dst = s_base + off
                                    + st * L::KV_BYTES + c * BK * L::ROW
                                    + hh * L::HALF * L::ROW;
                                const int row = t0 + hh * L::HALF;
                                if (mcast)
                                    tma_load_4d_mc(dst, map, full,
                                                   c * L::COLS, row, hk, b,
                                                   0x3);
                                else
                                    tma_load_4d(dst, map, full,
                                                c * L::COLS, row, hk, b);
                            }
                    };
                    mbar_wait(empty_k(st), ph ^ 1);
                    handshake(peer_k(st));
                    mbar_expect_tx(full_k(st), L::KV_BYTES);
                    load(L::K_OFF, &tm_k, full_k(st));
                    mbar_wait(empty_v(st), ph ^ 1);
                    handshake(peer_v(st));
                    mbar_expect_tx(full_v(st), L::KV_BYTES);
                    load(L::V_OFF, &tm_v, full_v(st));
                    continue;
                }
"""

MC_LAUNCH = r"""    if constexpr (Layout<D>::CLUSTER) {
        // clusters of the two CTAs of heads h, h ^ 1: grid y even
        const int hp = (H + 1) & ~1;
        if (hp > 65535) return (int)cudaErrorInvalidValue;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3((S + BQ - 1) / BQ, hp, B);
        cfg.blockDim = dim3(THREADS);
        cfg.dynamicSmemBytes = smem;
        cfg.stream = stream;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = 1;
        attr[0].val.clusterDim.y = 2;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        ce = cudaLaunchKernelEx(
            &cfg, flash_attention_tc_kernel<D, LSE, CAP>, mq, mk, mv,
            static_cast<__nv_bfloat16*>(out), S, T_len, H, Hkv, causal,
            window, q_offset, (float)((double)scale * 1.4426950408889634),
            lse, static_cast<__nv_bfloat16*>(out_lo),
            softcap_k2(scale, CAP ? softcap : 0.0f),
            CAP ? (float)((double)softcap * 1.4426950408889634) : 0.0f);
        if (ce != cudaSuccess) return (int)ce;
        return (int)cudaGetLastError();
    }
"""


def multicast(src):
    """D = 128, 192: clusters of two CTAs, heads h and h ^ 1 of one q
    tile, each K/V tile loaded once for both by TMA multicast when they
    read one kv head (the producers' handshake frees a stage)."""
    src = replace(src, "    static constexpr bool WIDE = D > 64;\n",
                  "    static constexpr bool WIDE = D > 64;\n"
                  "    static constexpr bool CLUSTER = D > 64;\n")
    src = replace(src, "    static constexpr int KEYS = D <= 128 ? BK : 96;\n",
                  "    static constexpr int KEYS = D <= 128 ? BK : 96;\n"
                  "    static constexpr int HALF = CLUSTER ? KEYS / 2 : KEYS;"
                  "   // box rows\n")
    # q_full, full_k, full_v, empty_k, empty_v and peer_k, peer_v a stage
    src = replace(src, "BAR_OFF + 8 * (1 + 4 * DEPTH);",
                  "BAR_OFF + 8 * (1 + (CLUSTER ? 6 : 4) * DEPTH);")
    src = replace(src, "// O += P . V for 16 keys: one m64nDk16.",
                  MC_HELPERS + "// O += P . V for 16 keys: one m64nDk16.")
    # peer_k, peer_v of every stage, arrived on by the other CTA's
    # producer once that CTA's readers have freed the stage
    src = replace(src, """    auto empty_v = [&](int st) { return bar + 8 * (1 + 3 * STAGES + st); };
""", """    auto empty_v = [&](int st) { return bar + 8 * (1 + 3 * STAGES + st); };
    auto peer_k = [&](int st) { return bar + 8 * (1 + 4 * STAGES + st); };
    auto peer_v = [&](int st) { return bar + 8 * (1 + 5 * STAGES + st); };
""")
    src = replace(src, """    const int hk = h / (H / Hkv);

    // The keys this CTA walks""", """    const int hk = h / (H / Hkv);
""" + MC_HEADS + """    // The keys this CTA walks""")
    src = replace(src, """            mbar_init(empty_v(st), 8);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
    }
    __syncthreads();
""", """            mbar_init(empty_v(st), 8);
            if constexpr (L::CLUSTER) {
                mbar_init(peer_k(st), 1);  // the other CTA's producer
                mbar_init(peer_v(st), 1);
            }
        }
        asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
    }
""" + MC_SYNC)
    src = replace(src, """                mbar_wait(empty_k(st), ph ^ 1);
                mbar_expect_tx(full_k(st), L::KV_BYTES);
""", MC_PRODUCER + """                mbar_wait(empty_k(st), ph ^ 1);
                mbar_expect_tx(full_k(st), L::KV_BYTES);
""")
    # no CTA of a cluster exits while the other may still multicast into
    # it or arrive on its barriers
    src = replace(src, """}

// ---- host side: tensor maps""", """    if constexpr (L::CLUSTER) cluster_sync();
}

// ---- host side: tensor maps""")
    src = src.replace("Layout<D>::KEYS};", "Layout<D>::HALF};")
    return replace(src, """    const dim3 grid((S + BQ - 1) / BQ, H, B);
    flash_attention_tc_kernel<D, LSE, CAP><<<""", MC_LAUNCH + """    const dim3 grid((S + BQ - 1) / BQ, H, B);
    flash_attention_tc_kernel<D, LSE, CAP><<<""")


def no_multicast(src):
    """The clusters of ``multicast``, every CTA loading its own K/V
    tiles (no multicast, no handshake)."""
    return replace(multicast(src),
                   "const int mcast = L::CLUSTER && (h | 1) < H",
                   "const int mcast = 0 && L::CLUSTER && (h | 1) < H")


def rescale_under_qk(src):
    """o's rescale by corr after Q.K^T is issued, under it, and before
    P.V is issued (v0: before both, inside the turn)."""
    return replace(src, """                turn_begin();
                // o's rescale before the products: no register of an
                // issued product is written until its wait
                rescale<D>(o, corr);
                wgmma_fence();
                issue_qk(st);
                wgmma_commit();
                issue_pv(sp);""", """                turn_begin();
                wgmma_fence();
                issue_qk(st);
                wgmma_commit();
                rescale<D>(o, corr);
                wgmma_fence();
                issue_pv(sp);""")


def keys64(src):
    """D = 192: K/V tiles of 64 keys in a 3-stage ring (v0: 96 keys in
    2 stages; the tiling before the output staging: 64 keys in 2)."""
    src = replace(src, "static constexpr int KEYS = D <= 128 ? BK : 96;",
                  "static constexpr int KEYS = D <= 128 ? BK : 64;")
    return replace(src,
                   "static constexpr int DEPTH = D == 192 ? 2 : WIDE ? 3 "
                   ": STAGES;",
                   "static constexpr int DEPTH = WIDE ? 3 : STAGES;")


def f32_keys32(src):
    """The f32 kernel at D = 192: K/V tiles of 32 keys (v0: 48)."""
    return replace(src, "__host__ __device__ constexpr int fa_keys() "
                        "{ return D <= 128 ? FA_BK : 48; }",
                   "__host__ __device__ constexpr int fa_keys() "
                   "{ return D <= 128 ? FA_BK : 32; }")


def f32_unroll4(src):
    """The f32 kernel above D = 64: S's k-steps unrolled 4 (v0: 2)."""
    return replace(src, "#define FA_WIDE_UNROLL 2", "#define FA_WIDE_UNROLL 4")


def _bwd_tool():
    """tools/k4_bwd_variants.py, which holds the split bodies and the
    scaled mode both tools run."""
    spec = importlib.util.spec_from_file_location(
        "k4_bwd_variants", Path(__file__).with_name("k4_bwd_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


KBV = _bwd_tool()


def _own_split(src, body, name):
    """The forward's include of the shared split replaced by a tf32_split
    of ``body`` (the pair keeps the shared one)."""
    return KBV._apply(name, src, [KBV.own_split(body, "forward")])


def f32_rna(src):
    """The f32 kernel's split: hi and lo each by cvt.rna."""
    return _own_split(src, KBV.RNA, "f32_rna")


def f32_rnahi(src):
    """The f32 kernel's split: hi rounded to nearest, lo whole."""
    return _own_split(src, KBV.RNA_HI, "f32_rnahi")


def remote_arrivals(src):
    """``multicast`` with the stage freed by the consumers' own warps:
    each arrives on both CTAs' empty barriers (lane 0 of a warp, a
    remote arrival on the other CTA's), and the producers do not
    handshake."""
    src = replace(multicast(src), """            mbar_init(empty_k(st), 8);     // lane 0 of each consumer warp
            mbar_init(empty_v(st), 8);""", """            mbar_init(empty_k(st), 8 * (mcast ? 2 : 1));
            mbar_init(empty_v(st), 8 * (mcast ? 2 : 1));""")
    src = replace(src, "                        if (!mcast) return;",
                  "                        return;")
    src = replace(src, """        const int row_pos = pa + 16 * warp + (lane >> 2);
""", """        const int row_pos = pa + 16 * warp + (lane >> 2);
        auto arrive2 = [&](uint32_t e) {
            mbar_arrive(e);
            mbar_arrive_remote(e, rank ^ 1, mcast);
        };
""")
    n = src.count("if (lane == 0) mbar_arrive(")
    if n != 4:
        raise SystemExit(f"k4_variants: {n} lane-0 arrivals, expected 4")
    src = src.replace("if (lane == 0) mbar_arrive(", "if (lane == 0) arrive2(")
    return replace(src, """            if (lane == 0) {
                mbar_arrive(empty_k(st));
                mbar_arrive(empty_v(st));
            }""", """            if (lane == 0) {
                arrive2(empty_k(st));
                arrive2(empty_v(st));
            }""")


def remote_arrivals_no_mc(src):
    """``remote_arrivals``' barriers, every CTA loading its own K/V
    tiles: what the cross-CTA arrivals cost without the multicast."""
    src = replace(remote_arrivals(src),
                  "const int h_lo = mcast ? (int)rank : 0;",
                  "const int h_lo = 0;")
    src = replace(src, "const int h_hi = mcast ? (int)rank + 1 : 2;",
                  "const int h_hi = 2;")
    return replace(src, """                                if (mcast)
                                    tma_load_4d_mc(""", """                                if (0)
                                    tma_load_4d_mc(""")


def depth2(src):
    """A 2-stage K/V ring at D = 128 (v0: 3)."""
    return replace(src,
                   "static constexpr int DEPTH = D == 192 ? 2 : WIDE ? 3 "
                   ": STAGES;",
                   "static constexpr int DEPTH = WIDE ? 2 : STAGES;")


# The capped bf16 score (softmax_tile, twice: masked and interior tiles)
# and the launch's constant of fa_hopper.cuh's softcap_r
CAP_TILE = "fmaf(cap_m2, softcap_r(s[i], k2), cap_log2)"
CAP_K2 = "softcap_k2(scale, CAP ? softcap : 0.0f),"


def tanhf(src):
    """The capped bf16 forward as PR 33 wrote it: ``cap_turns``, and the
    score cap_log2 * tanhf(s * scale / cap), the accurate tanh (a branch
    on |x|, ~20 FP32 instructions and 2 SFU operations), the launch
    passing scale / cap in k2's place."""
    src = cap_turns(src)
    if src.count(CAP_TILE) != 2:
        raise SystemExit("k4_variants: the capped score not found twice")
    src = src.replace(CAP_TILE, "cap_log2 * tanhf(s[i] * k2)")
    return replace(src, CAP_K2,
                   "CAP ? (float)((double)scale / softcap) : 0.0f,")


# 2^x on the FMA pipe, for the capped softmax's exponent: a Cody-Waite
# split x = j + f (j = rint(x) by the 1.5 * 2^23 shift, f in [-0.5,
# 0.5]), 2^f by Cephes' exp2f polynomial (~2^-23 relative), j added into
# the exponent; x below -127 (masked keys: -inf, NEG - m) gives 0
EX2_FMA = r"""__device__ __forceinline__ float ex2_fma(float x) {
    x = fmaxf(x, -127.0f);
    const float t = x + 12582912.0f;
    const float f = x - (t - 12582912.0f);
    float p = 1.535336188319500e-4f;
    p = fmaf(p, f, 1.339887440266574e-3f);
    p = fmaf(p, f, 9.618437357674640e-3f);
    p = fmaf(p, f, 5.550332471162809e-2f);
    p = fmaf(p, f, 2.402264791363012e-1f);
    p = fmaf(p, f, 6.931472028550421e-1f);
    p = fmaf(p, f, 1.0f);
    return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}

"""
SOFTMAX_EXP = """        s[i] = MASK || CAP ? ex2(s[i] - m_new[r])
                           : ex2(fmaf(s[i], scale_log2, -m_new[r]));"""


def fma_exp(src):
    """The capped softmax's exponent on the FMA pipe (``EX2_FMA``) for
    element i with i % FA_FMA_EXP_EVERY == FA_FMA_EXP_EVERY - 1 (the -D
    switch: 2 half, 4 a quarter), ex2 on the SFU for the rest: the SFU
    is then not the only pipe that binds."""
    src = replace(src, "// One warpgroup's 64 rows against one tile of N/2 "
                  "keys", EX2_FMA + "// One warpgroup's 64 rows against one "
                  "tile of N/2 keys")
    return replace(src, SOFTMAX_EXP, """        s[i] = CAP && i % FA_FMA_EXP_EVERY == FA_FMA_EXP_EVERY - 1
                   ? ex2_fma(s[i] - m_new[r])
                   : MASK || CAP ? ex2(s[i] - m_new[r])
                                 : ex2(fmaf(s[i], scale_log2, -m_new[r]));""")


# name -> (patches, -D switches, tolerance against gqa_plain or None for
# an ablation that does not compute attention)
VARIANTS = {
    "v0": ((), (), TOL),
    "p_single": ((single_p,), (), TOL_P_SINGLE),
    "serial": ((serial,), (), TOL),
    "serial_tree4": ((serial, tree), ("-DFA_NA=4",), TOL),
    "overlap": ((no_turns,), (), TOL),
    "pingpong_branching": ((branching_turns,), (), TOL),
    "all_lanes": ((all_lanes,), (), TOL),
    "serial_bq192": ((serial, knobs), ("-DFA_NWG=3",), TOL),
    "overlap_bq192": ((no_turns, knobs), ("-DFA_NWG=3",), TOL),
    "stages4": ((knobs,), ("-DFA_STAGES=4",), TOL),
    "l2_256": ((knobs,), ("-DFA_L2_256",), TOL),
    "multicast": ((multicast,), (), TOL),
    "multicast_loads_only": ((multicast, ablations),
                             ("-DABL_NOQK", "-DABL_NOPV", "-DABL_NOSOFTMAX"),
                             None),
    "remote_arrivals": ((remote_arrivals,), (), TOL),
    "remote_arrivals_no_mc": ((remote_arrivals_no_mc,), (), TOL),
    "no_multicast": ((no_multicast,), (), TOL),
    "depth2": ((depth2,), (), TOL),
    "tanhf": ((tanhf,), (), TOL),
    "cap_turns": ((cap_turns,), (), TOL),
    "fma_exp": ((fma_exp,), ("-DFA_FMA_EXP_EVERY=2",), TOL),
    "fma_exp_quarter": ((fma_exp,), ("-DFA_FMA_EXP_EVERY=4",), TOL),
    "rescale_under_qk": ((rescale_under_qk,), (), TOL),
    "keys64": ((keys64,), (), TOL),
    "f32_keys32": ((f32_keys32,), (), TOL),
    "f32_unroll4": ((f32_unroll4,), (), TOL),
    "f32_rna": ((f32_rna,), (), TOL),
    "f32_rnahi": ((f32_rnahi,), (), TOL),
    "no_softmax": ((ablations,), ("-DABL_NOSOFTMAX",), None),
    "no_products": ((ablations,), ("-DABL_NOQK", "-DABL_NOPV"), None),
    "loads_only": ((ablations,), ("-DABL_NOQK", "-DABL_NOPV",
                                  "-DABL_NOSOFTMAX"), None),
    "loads_only_bq192": ((no_turns, knobs, ablations),
                         ("-DFA_NWG=3", "-DABL_NOQK", "-DABL_NOPV",
                          "-DABL_NOSOFTMAX"), None),
}


# the variants that change the capped bf16 forward: built with their
# softcap instantiations, as v0, and with ``--shapes capped`` checked on
# the capped cases and timed at the capped layers
CAPPED = ("tanhf", "cap_turns", "fma_exp", "fma_exp_quarter")
# the variants that keep the committed consumer at every head dim (or
# switch parts of it off): checked and timed at D = 128 and 192 too
WIDE = ("v0", "p_single", "overlap", "pingpong_branching", "all_lanes",
        "stages4", "l2_256", "multicast", "multicast_loads_only",
        "remote_arrivals", "remote_arrivals_no_mc", "no_multicast", "depth2",
        "rescale_under_qk", "keys64", "f32_keys32", "f32_unroll4",
        "f32_rna", "f32_rnahi", *CAPPED, "no_softmax", "no_products",
        "loads_only")
# the variants that change the f32 kernel: also checked in f32 and timed
# at the f32 training shapes
F32 = ("f32_keys32", "f32_unroll4", "f32_rna", "f32_rnahi")
# the f32 variants that change the split, and the k4_bwd_variants variant
# of the same split that --scaled runs (forward and pair together)
SPLIT_OF = {"f32_rna": "rna", "f32_rnahi": "rnahi"}


def build(names, baselines=None, with_cap=()):
    """Build every named variant (and each baseline NAME -> source text)
    in parallel, those of ``with_cap`` (and v0, the f32 and the capped
    variants) with their softcap instantiations; name -> (library,
    ptxas lines)."""
    from repro_torch.kernels import _build
    committed = (_build.CSRC / "flash_attention.cu").read_text()
    # v0 and the f32 variants carry their own softcap instantiations:
    # the launches of the library's second unit appended to the
    # variant's text (one translation unit); every other source a stub
    # refusing a cap, in the entry's signature since the cap took lse
    # and in the one before
    capped = (_build.CSRC / "flash_attention_softcap.cu").read_text() \
        .split('#include "flash_attention.cu"', 1)[1]
    stub = """
int fa_fwd_softcap(const void*, const void*, const void*, void*, int, int,
                   int, int, int, int, int, const long long*, int, int, int,
                   float, cudaStream_t, float) {
    return (int)cudaErrorNotSupported;
}
int fa_fwd_softcap(const void*, const void*, const void*, void*, int, int,
                   int, int, int, int, int, const long long*, int, int, int,
                   float, cudaStream_t, float, float*, void*) {
    return (int)cudaErrorNotSupported;
}
"""
    OUT.mkdir(parents=True, exist_ok=True)
    baselines = baselines or {}
    procs = {}
    for name in names:
        patches, defines, _ = VARIANTS.get(name, ((), (), TOL))
        src = baselines.get(name, committed)
        for patch in patches:
            src = patch(src)
        cu = OUT / f"{name}.cu"
        cu.write_text(src + (capped if name in ("v0", *F32, *CAPPED,
                                                *with_cap) else stub))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", *defines,
             "-Xptxas", "-v", "-o", str(OUT / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k4_variants: {name} failed to build:\n{out}")
        keep = [ln.strip() for ln in out.splitlines()
                if "tc_kernel" in ln or "registers" in ln or "spill" in ln
                or "C75" in ln or "smem" in ln]
        libs[name] = (ctypes.CDLL(str(OUT / f"lib{name}.so")), keep)
    return libs


def use(lib):
    """Route ``flash_attention`` to ``lib``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    lib.flash_attention_fwd.argtypes = fa._ARGTYPES
    lib.flash_attention_fwd.restype = ctypes.c_int
    _build._LIBS["flash_attention"] = lib


def wide_cases(gen, dtype):
    """The head dims 128 and 192 of ``chip_smoke.py``
    (``WIDE_HEAD_CASES``, ``WIDE_BWD_EDGE_CASES``, ``FWD_HEAD_EDGE_CASES``)
    in ``dtype``."""
    import chip_smoke
    import torch
    out = []
    for name, (b, s, t, h, hkv, d), kw in (chip_smoke.WIDE_HEAD_CASES
                                           + chip_smoke.WIDE_BWD_EDGE_CASES
                                           + chip_smoke.FWD_HEAD_EDGE_CASES):
        q, k, v = (torch.randn(*x, generator=gen, device="cuda").to(dtype)
                   for x in ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d)))
        out.append((name, (q, k, v), kw))
    return out


def cases(gen):
    import torch

    def qkv(b, s, t, h, hkv, d):
        def r(*shape):
            return torch.randn(*shape, generator=gen,
                               device="cuda").to(torch.bfloat16)
        return r(b, s, h, d), r(b, t, hkv, d), r(b, t, hkv, d)

    fused = torch.randn(2, 300, 12, 64, generator=gen,
                        device="cuda").to(torch.bfloat16)
    return [
        ("d64-causal", qkv(3, 128, 128, 1, 1, 64), {}),
        ("d32-causal", qkv(3, 256, 256, 1, 1, 32), {}),
        ("d16-full", qkv(3, 256, 128, 1, 1, 16), {"causal": False}),
        ("tail-1000", qkv(1, 1000, 1000, 5, 1, 64), {}),
        ("s1050-empty-warpgroup", qkv(1, 1050, 1050, 5, 1, 64), {}),
        ("q-offset-64", qkv(2, 200, 264, 4, 1, 64), {"q_offset": 64}),
        ("window-100", qkv(1, 1000, 1000, 5, 1, 64), {"window": 100}),
        ("window-1000", qkv(1, 2000, 2000, 5, 1, 64), {"window": 1000}),
        ("half-block-blind", qkv(1, 128, 128, 2, 1, 64),
         {"causal": False, "window": 32, "q_offset": 100}),
        ("warpgroup-skips-7-tiles", qkv(1, 128, 1000, 2, 1, 64),
         {"causal": False, "window": 64, "q_offset": 980}),
        ("strided", (fused[:, :, :8], fused[:, :, 8:10], fused[:, :, 10:]),
         {"window": 64}),
    ]


def capped_checks(libs, names):
    """Each of ``names`` on ``chip_smoke.check_softcap``'s cases, as
    ``softcap_checks`` draws them in bf16 (every head dim,
    ``SOFTCAP_MASKS``, caps of ``SOFTCAP_CAPS``, q scaled by 2 caps);
    returns the failures."""
    import chip_smoke
    import torch
    gen = torch.Generator(device="cuda").manual_seed(13)
    bad = []
    for name in names:
        use(libs[name][0])
        worst, n = 0.0, 0
        for d in chip_smoke.HEAD_DIMS:
            for b, s, t, h, hkv, causal, window, off in \
                    chip_smoke.SOFTCAP_MASKS:
                q = torch.randn(b, s, h, d, generator=gen, device="cuda")
                k, v = (torch.randn(b, t, hkv, d, generator=gen,
                                    device="cuda") for _ in range(2))
                for cap in chip_smoke.SOFTCAP_CAPS:
                    case = f"d{d}-{causal}-w{window}-off{off}-cap{cap:g}"
                    try:
                        row = chip_smoke.check_softcap(
                            f"{name}/{case}",
                            (q * (2 * cap)).to(torch.bfloat16),
                            k.to(torch.bfloat16), v.to(torch.bfloat16), cap,
                            causal=causal, window=window, q_offset=off)
                        worst = max(worst, row["max_abs_err"])
                    except SystemExit as e:
                        bad.append(str(e))
                    n += 1
        print(json.dumps({"variant": name, "capped_checked": n,
                          "capped_worst_max_abs_err": worst}), flush=True)
    return bad


def capped_times(libs, names, gen):
    """ms of each of ``names`` at ``CAP_SHAPES``, in turns."""
    import chip_smoke
    import torch
    from repro_torch.kernels import flash_attention as fa
    times = {}
    for shape, (b, s, h, hkv, d, cap, lse) in CAP_SHAPES.items():
        q, k, v = (torch.randn(b, s, n, d, generator=gen, device="cuda")
                   .to(torch.bfloat16) for n in (h, hkv, hkv))
        if lse:
            def call():
                return fa._kernel_forward(q, k, v, True, 0, 0,
                                          with_lse=True, softcap=cap)
        else:
            def call():
                return fa.flash_attention(q, k, v, causal=True, softcap=cap)
        times[shape] = {}
        for name in names + names[::-1]:
            use(libs[name][0])
            times[shape].setdefault(name, []).append(chip_smoke.median_ms(
                call, runs=5, per_run=10))
        print(json.dumps({"shape": shape, "ms": times[shape]}), flush=True)
    return times


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(VARIANTS),
                    help="comma-separated variants (v0 is always built)")
    ap.add_argument("--prefill", action="store_true",
                    help="also the bf16 hymba prefill against the f32 "
                         "forward, with each checked variant")
    ap.add_argument("--shapes", choices=("narrow", "wide", "all", "capped"),
                    default="all",
                    help="time at head dim 64, at 128 and 192, or both; "
                         "capped: llama's layer without a cap, then v0 and "
                         "the capped variants checked on the softcap cases "
                         "and timed at llama's capped layers")
    ap.add_argument("--baseline", action="append", default=[],
                    help="NAME=FILE.cu: another source as variant NAME")
    ap.add_argument("--scaled", action="store_true",
                    help="k4_bwd_variants.py's scaled mode on v0 and "
                         "the f32 split variants (forward and pair with "
                         "one split)")
    args = ap.parse_args(argv)
    names = ["v0"] + [n for n in args.only.split(",") if n and n != "v0"]
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"k4_variants: unknown variants {unknown}")
    baselines = {}
    for spec in args.baseline:
        name, _, path = spec.partition("=")
        if not name or not path or name in VARIANTS or name in baselines:
            raise SystemExit(f"k4_variants: --baseline {spec!r}: want a "
                             f"new NAME=FILE.cu")
        baselines[name] = Path(path).read_text()
    names += list(baselines)
    wide = set(WIDE) | set(baselines)
    if not torch.cuda.is_available():
        print("k4_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import flash_attention as fa
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    # --shapes capped: every variant of the committed consumer capped too
    with_cap = [n for n in names if n in WIDE] \
        if args.shapes == "capped" else []
    libs = build(names, baselines, with_cap)
    for name in names:
        print(json.dumps({"variant": name, "ptxas": libs[name][1]}),
              flush=True)
    gen = torch.Generator(device="cuda").manual_seed(10)
    checks = cases(gen)
    checks_wide = wide_cases(gen, torch.bfloat16)
    checks_f32 = wide_cases(gen, torch.float32)
    f32 = {"v0", *F32, *baselines}
    bad = []
    for name in names:
        tol = VARIANTS[name][2] if name in VARIANTS else TOL
        if tol is None:
            continue
        use(libs[name][0])
        worst = 0.0
        mine = [(c, x, kw, tol) for c, x, kw in
                checks + (checks_wide if name in wide else [])]
        if name in f32 and name in F32:
            mine += [(c, x, kw, TOL_F32) for c, x, kw in checks_f32]
        for cname, (q, k, v), kw, tol in mine:
            want = fa.gqa_plain(q, k, v, **kw)
            got = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            worst = max(worst, err)
            if not torch.allclose(got.float(), want.float(), rtol=tol[0],
                                  atol=tol[1]):
                bad.append(f"{name}/{cname}: max abs {err}")
        print(json.dumps({"variant": name, "checked": len(mine),
                          "worst_max_abs_err": worst, "tol": tol}),
              flush=True)
    capped = [n for n in names if n in ("v0", *CAPPED, *with_cap)]
    if args.shapes == "capped":
        bad += capped_checks(libs, [n for n in capped
                                    if VARIANTS[n][2] is not None])
    times = {}
    shapes = {"narrow": SHAPES, "wide": WIDE_SHAPES,
              "all": {**SHAPES, **WIDE_SHAPES},
              "capped": {"llama-4096-causal": SHAPES["llama-4096-causal"]}
              }[args.shapes].copy()
    if args.shapes in ("wide", "all") and any(n in F32 for n in names):
        shapes.update(F32_SHAPES)
    for shape, (b, s, h, hkv, window, d) in shapes.items():
        dtype = torch.float32 if shape in F32_SHAPES else torch.bfloat16

        def r(*shape_):
            return torch.randn(*shape_, generator=gen,
                               device="cuda").to(dtype)
        q, k, v = r(b, s, h, d), r(b, s, hkv, d), r(b, s, hkv, d)
        if shape in F32_SHAPES:
            timed = [n for n in names if n in f32]

            def call():
                return fa._kernel_forward(q, k, v, True, window, 0,
                                          with_lse=True)
        else:
            timed = [n for n in names if d <= 64 or n in wide]

            def call():
                return fa.flash_attention(q, k, v, window=window)
        times[shape] = {}
        for name in timed + timed[::-1]:
            use(libs[name][0])
            times[shape].setdefault(name, []).append(chip_smoke.median_ms(
                call, runs=5, per_run=10))
        print(json.dumps({"shape": shape, "ms": times[shape]}), flush=True)
    if args.shapes == "capped":
        times.update(capped_times(libs, capped, gen))
    scaled = {}
    if args.scaled:
        scaled, ok = KBV.run(["v0"] + [SPLIT_OF[n] for n in names
                                       if n in SPLIT_OF], with_scaled=True)
        if not ok:
            bad.append("--scaled: a split's pair failed its checks")
    prefill = {}
    if args.prefill:
        cfg, params = chip_smoke._lm_params("hymba-1.5b", torch.bfloat16)
        for name in names:
            if VARIANTS.get(name, (None, None, TOL))[2] is not None:
                use(libs[name][0])
                prefill[name] = chip_smoke.bf16_prefill_vs_f32(cfg, params)
                print(json.dumps({"variant": name,
                                  "prefill_vs_f32": prefill[name]}),
                      flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "failed": bad, "ms": times,
                      "prefill_vs_f32": prefill, "scaled": scaled}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
