#!/usr/bin/env python3
"""Variants of K4's bf16 backward kernels (``csrc/flash_attention_bwd_tc.cu``:
dq, dkdv on ``wgmma`` fed by TMA) on one GPU, timed in turns.

    python3 tools/k4_bwd_tc_variants.py [--only v0,masks_always,...]
                                        [--baseline NAME=FILE.cu ...]
                                        [--softcap CAP]

Each variant is the committed source with text patches (and, with each
``--baseline``, another source of the same two entry points,
``flash_attention_bwd_dq_bf16`` and ``_dkdv_bf16`` -- an earlier
commit's ``flash_attention_bwd.cu``, say -- as the variant NAME), built
with ``nvcc -Xptxas -v`` into ``build/k4_bwd_tc_variants/``, all at
once: registers, spills and ptxas's C75xx notes are printed.  Every
variant that computes the gradient goes through the wrapper
(``FlashAttentionFn``) and ``chip_smoke.check_flash_bwd_bf16`` on
``chip_smoke.BF16_BWD_CASES`` at ``BF16_BWD_TOL`` (with ``--softcap``:
``chip_smoke.check_softcap_bwd`` on ``softcap_bwd_checks``' bf16 cases,
the committed capped forward's lse); then all are timed with
``chip_smoke.median_ms`` at ``chip_smoke.FA_BWD_BF16_SHAPES`` (with the
cap ``--softcap``, 0 by default), each kernel launched directly and the
pair through the wrapper's backward, in turns: the variants in order,
then reversed.  The last line of standard output is one JSON object of the
times and the checks.  Needs one CUDA card and nvcc; exits non-zero
otherwise or when a checked variant disagrees.

Variants:
  v0             the committed kernels
  masks_always   the masks on every tile and item (no interior path)
  cap_interior   dq's CAP tiles on the interior path where no mask
                 bites (v0: every CAP tile on the masked path)
  cap_wait_both  dkdv's earlier CAP item: on the masked path,
                 both products waited on before P^T and dS^T are formed
                 together from one r, then dV and dK one after the other
                 (v0: P^T under dP^T's product, below D = 128 dV issued
                 under dS^T, interior items without the masks)
  cap_late_dv    dkdv's CAP item below D = 128 with both second products
                 after dS^T, one after the other (v0: dV issued before
                 dP^T is waited for, dS^T formed under it)
  cap_kv_masked  dkdv's CAP items all on the masked path, as dq's CAP
                 tiles (v0: an item whose rows all see every key of the
                 warpgroup takes the interior path, capped)
  cap_split_wait dkdv's CAP item from D = 128 with both products waited on
                 before P^T is formed (v0: P^T under dP^T's product)
  tanhf          the capped pair as PR 33 wrote it: the accurate tanhf
                 and 1 - t^2 in place of fa_hopper.cuh's softcap_r (one
                 ex2, one rcp) and 4 r (1 - r); dkdv's item as cap_wait_both
  one_part       P and dS as one bf16 part each (the lo products gone):
                 what the second part costs; not checked (it misses the
                 tolerance, tests/test_torch_k4_bf16_wgmma_bwd.py)
  both_products  dkdv up to D = 80: dV and dK issued in one commit
                 group (the committed kernels wait between them)
  overlap        FA3's overlap within a warpgroup: the next tile's or
                 item's S and dP issued under this one's second products
  kv64           dkdv blocks of 64 keys at every D, dv and dk split
                 between the warpgroups (the committed kernels: from D =
                 128 on): twice the blocks, S^T and dP^T in both
  NAME           a source given with --baseline NAME=FILE.cu, as it is
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "k4_bwd_tc_variants"
SOURCE = ROOT / "src/repro_torch/kernels/csrc/flash_attention_bwd_tc.cu"

# the interior tests (a CAP tile or item never takes the interior path:
# it caps every score on the masked one), and dq's interior loop
DQ_INTERIOR = "                if (!CAP && t0 + BK <= T && r0 + 64 <= S\n"
KV_INTERIOR = "            if (r0 + BM <= S && kw0 + 64 <= T\n"
DQ_INTERIOR_LOOP = """                    for (int i = 0; i < 32; ++i)
                        s[i] = ex2(fmaf(s[i], scale_log2,
                                        -(((i >> 1) & 1) ? lse_b : lse_a)));
"""
# dq's interior loop with a CAP branch: the capped score as the masked
# path forms it, without the masks
DQ_INTERIOR_CAP = """                    for (int i = 0; i < 32; ++i) {
                        const bool rb_ = (i >> 1) & 1;
                        if constexpr (CAP) {
                            const float r = softcap_r(s[i], k2);
                            s[i] = ex2(fmaf(cap_m2, r, rb_ ? cl_b : cl_a))
                                   * fmaf(-r, r, r);
                        } else {
                            s[i] = ex2(fmaf(s[i], scale_log2,
                                            -(rb_ ? lse_b : lse_a)));
                        }
                    }
"""
# the capped scores (fa_hopper.cuh: softcap_r) on dq's masked path and
# dkdv's, and their launches' constant; PR 33's, with the accurate tanhf
# on scale / cap (passed in k2's place)
DQ_CAP = """                            const float r = softcap_r(s[i], k2);
                            s[i] = vis ? ex2(fmaf(cap_m2, r,
                                                  rb_ ? cl_b : cl_a))
                                             * fmaf(-r, r, r)
                                       : 0.0f;
"""
DQ_TANHF = """                            const float th = tanhf(s[i] * k2);
                            s[i] = vis ? ex2(cap_log2 * th
                                             - (rb_ ? lse_b : lse_a))
                                             * (1.0f - th * th)
                                       : 0.0f;
"""
KV_CAP = """                        const float r = softcap_r(s[e], k2);
                        s[e] = none ? (in ? inv_t : 0.0f)
                                    : vis ? ex2(fmaf(cap_m2, r, cap_log2
                                                     - lse_c[col]))
                                          : 0.0f;
                        // D >= 128: warpgroup 1 sums dv from P^T alone
                        if (!SPLIT || w)
                            dtanh[e] = none ? 0.0f : fmaf(-r, r, r);
"""
# dkdv's earlier CAP item: both products waited on before any cap work,
# P^T and dS^T formed together from one r, the second products shared
# with the kernels without a cap (one after the other)
KV_CAP_TOGETHER = """                        const float r = softcap_r(s[e], k2);
                        s[e] = none ? (in ? inv_t : 0.0f)
                                    : vis ? ex2(fmaf(cap_m2, r, cap_log2
                                                     - lse_c[col]))
                                          : 0.0f;
                        dp[e] = none ? 0.0f
                                     : s[e] * (dp[e] - dl_c[col])
                                           * (4.0f * fmaf(-r, r, r));
"""
KV_DTANH = """            // CAP: (1 - t^2) / 4 = r (1 - r) of each element (its 4 in
            // dk's scale; 0 where the row sees no key, so that dS^T = 0),
            // kept from P^T's r, formed under dP^T's product, until dS^T
            float dtanh[CAP ? 32 : 1];
"""
KV_WAIT_BOTH = """            if constexpr (CAP) {
                // both products waited on: P^T in S^T's place and dS^T
                // in dP^T's, from one t an element, on every item
                wgmma_wait<0>();
                fence_regs(s);
                fence_regs(dp);
            }
"""
# the CAP item's second products (from its comment up to the products
# without a cap, which the earlier CAP item shared)
# dkdv's interior loop: with its CAP branch (the capped P^T and r (1 -
# r) as the masked path forms them, without the masks), and without
KV_INTERIOR_CAP = """                    if constexpr (CAP) {
                        const float r = softcap_r(s[e], k2);
                        s[e] = ex2(fmaf(cap_m2, r, cap_log2 - lse_c[col]));
                        if (!SPLIT || w) dtanh[e] = fmaf(-r, r, r);
                    } else {
                        s[e] = ex2(fmaf(s[e], scale_log2, -lse_c[col]));
                    }
"""
KV_INTERIOR_LOOP = """                    s[e] = ex2(fmaf(s[e], scale_log2, -lse_c[col]));
"""
KV_CAP_PRODUCTS = """            if constexpr (CAP && SPLIT) {
                // dS^T / 4 = P^T (dP^T - delta) r (1 - r) in P^T's place
"""
# the split tail's operand select (a CAP item from D = 128 forms its own
# in place; the earlier item's dS^T sat in dP^T's place, as without a cap)
KV_TAIL_SELECT = """                if constexpr (!CAP) {
#pragma unroll
                    for (int e = 0; e < 32; ++e) s[e] = w ? dp[e] : s[e];
                }
"""
KV_PLAIN_PRODUCTS = "            } else if constexpr (SPLIT) {\n"
KV_DK_MUL = "const float dk_mul = CAP ? 4.0f * scale : scale;"
# below D = 128: dV issued at once, dS^T formed under it (the committed
# item), or both second products after dS^T, one after the other
KV_EARLY_DV = """                split_frags(s, hi, lo);
#pragma unroll
                for (int e = 0; e < 32; ++e) s[e] *= dtanh[e];
                wgmma_fence();
                wgmma_parts<D, BM>(acc_v, hi, lo, s_do);
                wgmma_commit();
                wgmma_wait<1>();                // dP^T's product
                fence_regs(dp);
#pragma unroll
                for (int e = 0; e < 32; ++e) {
                    const int col = 8 * (e >> 2) + 2 * (lane & 3)
                                    + (e & 1);
                    dp[e] = (dp[e] - dl_c[col]) * s[e];
                }
                uint32_t ds_hi[4][4], ds_lo[4][4];
                split_frags(dp, ds_hi, ds_lo);
                wgmma_fence();
                wgmma_parts<D, BM>(acc, ds_hi, ds_lo, s_q);
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(acc_v);
                fence_regs(acc);
"""
KV_LATE_DV = """                wgmma_wait<0>();
                fence_regs(dp);
#pragma unroll
                for (int e = 0; e < 32; ++e) {
                    const int col = 8 * (e >> 2) + 2 * (lane & 3)
                                    + (e & 1);
                    dp[e] = (dp[e] - dl_c[col]) * s[e] * dtanh[e];
                }
                split_frags(s, hi, lo);
                wgmma_fence();
                wgmma_parts<D, BM>(acc_v, hi, lo, s_do);
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(acc_v);
                split_frags(dp, hi, lo);
                wgmma_fence();
                wgmma_parts<D, BM>(acc, hi, lo, s_q);
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(acc);
"""
KV_TANHF = """                        const float th = tanhf(s[e] * k2);
                        s[e] = none ? (in ? inv_t : 0.0f)
                                    : vis ? ex2(cap_log2 * th - lse_c[col])
                                          : 0.0f;
                        dp[e] = none ? 0.0f
                                     : s[e] * (dp[e] - dl_c[col])
                                           * (1.0f - th * th);
"""
CAP_K2 = "softcap_k2(scale, softcap)"
SC_CAP = "(softcap > 0.0f ? (float)((double)scale / softcap) : 0.0f)"
LO_PRODUCT = "        wgmma_rs_d<D, ROWS>(acc, lo[kk], s);\n"
SEQUENTIAL = """                split_frags(s, hi, lo);
                wgmma_fence();
                wgmma_parts<D, BM>(acc_v, hi, lo, s_do);    // dv += P^T.dO
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(acc_v);
                split_frags(dp, hi, lo);
                wgmma_fence();
                wgmma_parts<D, BM>(acc, hi, lo, s_q);       // dk += dS^T.Q
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(acc);"""
BOTH = """                uint32_t hi2[4][4], lo2[4][4];
                split_frags(s, hi, lo);
                split_frags(dp, hi2, lo2);
                wgmma_fence();
                wgmma_parts<D, BM>(acc_v, hi, lo, s_do);    // dv += P^T.dO
                wgmma_parts<D, BM>(acc, hi2, lo2, s_q);     // dk += dS^T.Q
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(acc_v);
                fence_regs(acc);"""

# the consumers' loops of ``overlap`` (from dq's accumulator to its
# store; from dkdv's accumulators to its stores)
DQ_START = ("        float acc[D / 2];\n        zero(acc);\n"
            "        const uint32_t s_q = s_base + L::A_OFF + w * 64 * L::ROW;")
DQ_END = "        store_rows<D>(dq + ((long long)b * S * H + h) * D, acc, scale, r0,"
KV_START = "        float acc[D / 2];                // dk (D >= 128: dv or dk)"
KV_END = "        const long long stride = (long long)Hkv * D;"
OVERLAP_DQ = r"""        float acc[D / 2];
        zero(acc);
        const uint32_t s_q = s_base + L::A_OFF + w * 64 * L::ROW;
        const uint32_t s_do = s_base + L::B_OFF + w * 64 * L::ROW;
        float s[32], dp[32];
        uint32_t ds_hi[4][4], ds_lo[4][4];
        // a tile these rows do not see: released once it has landed
        auto release = [&](int j) {
            const int st = j % DEPTH;
            mbar_wait(full(st), (j / DEPTH) & 1);
            if (lane == 0) mbar_arrive(empty(st));
        };
        // S = Q.K^T and dP = dO.V^T of tile j, two commit groups, once
        // its stage has landed
        auto issue_sdp = [&](int j) {
            const int st = j % DEPTH;
            mbar_wait(full(st), (j / DEPTH) & 1);
            wgmma_abt<D, BQ, BK>(s, s_q, stage(st));
            wgmma_commit();
            wgmma_abt<D, BQ, BK>(dp, s_do, stage(st) + L::MOV_BYTES);
            wgmma_commit();
        };
        // tile j: P from S while dP is on the tensor cores, dS, its two
        // parts, and dQ += dS.K issued (one commit group)
        auto step = [&](int j) {
            const int t0 = tile_lo + j * BK;
            // every key of the tile seen by every one of the 64 rows
            const bool interior = t0 + BK <= T && r0 + 64 <= S
                                  && (!causal || t0 + BK - 1 <= pa)
                                  && (window <= 0 || t0 >= pa + 64 - window);
            wgmma_wait<1>();
            fence_regs(s);
            // element i: row a or b by (i >> 1) & 1, key t0 + 8 (i / 4) +
            // 2 (lane % 4) + (i & 1)
            if (interior) {
#pragma unroll
                for (int i = 0; i < 32; ++i)
                    s[i] = ex2(fmaf(s[i], scale_log2,
                                    -(((i >> 1) & 1) ? lse_b : lse_a)));
            } else {
#pragma unroll
                for (int i = 0; i < 32; ++i) {
                    const int key = t0 + 8 * (i >> 2) + 2 * (lane & 3)
                                    + (i & 1);
                    const bool rb_ = (i >> 1) & 1;
                    const bool vis = rb_ ? key >= lo_b && key < hi_b
                                         : key >= lo_a && key < hi_a;
                    s[i] = vis ? ex2(fmaf(s[i], scale_log2,
                                          -(rb_ ? lse_b : lse_a)))
                               : 0.0f;
                }
            }
            wgmma_wait<0>();
            fence_regs(dp);
#pragma unroll
            for (int i = 0; i < 32; ++i)
                s[i] *= dp[i] - (((i >> 1) & 1) ? dl_b : dl_a);
            split_frags(s, ds_hi, ds_lo);
            wgmma_fence();
            wgmma_parts<D, BK>(acc, ds_hi, ds_lo, stage(j % DEPTH));
            wgmma_commit();
        };
        mbar_wait(bar, 0);
        for (int j = 0; j < j_a; ++j) release(j);
        if (j_a < j_b) {
            wgmma_fence();
            issue_sdp(j_a);
            // tile j + 1's S and dP issued under tile j's dQ product
            for (int j = j_a; j + 1 < j_b; ++j) {
                step(j);
                issue_sdp(j + 1);
                wgmma_wait<2>();
                fence_regs(acc);
                if (lane == 0) mbar_arrive(empty(j % DEPTH));
            }
            step(j_b - 1);
            wgmma_wait<0>();
            fence_regs(acc);
            if (lane == 0) mbar_arrive(empty((j_b - 1) % DEPTH));
        }
        for (int j = j_b; j < n_tiles; ++j) release(j);
"""
OVERLAP_KV = r"""        float acc[D / 2];                // dk (D >= 128: dv or dk)
        float acc_v[SPLIT ? 2 : D / 2];  // dv
        zero(acc);
        zero(acc_v);
        const uint32_t s_k = s_base + L::A_OFF + kw * L::ROW;
        const uint32_t s_v = s_base + L::B_OFF + kw * L::ROW;
        float s[32], dp[32];
        // the A operands of the second products, two bf16 parts each: P^T
        // (dv) and dS^T (dk); from D = 128 one of them, by warpgroup
        uint32_t a_hi[SPLIT ? 1 : 2][4][4], a_lo[SPLIT ? 1 : 2][4][4];
        // S^T = K.Q^T and dP^T = V.dO^T of item i, two commit groups, once
        // its stage has landed
        auto issue_sdp = [&](int i) {
            const int st = i % DEPTH;
            mbar_wait(full(st), (i / DEPTH) & 1);
            wgmma_abt<D, NK, BM>(s, s_k, stage(st));
            wgmma_commit();
            wgmma_abt<D, NK, BM>(dp, s_v, stage(st) + L::MOV_BYTES);
            wgmma_commit();
        };
        // item i: P^T from S^T while dP^T is on the tensor cores, dS^T,
        // their parts, and the second products issued (one commit group)
        auto step = [&](int i) {
            const int st = i % DEPTH;
            const int r0 = walk.tile(i / rep) * BM;
            const uint32_t s_q = stage(st);
            const uint32_t s_do = s_q + L::MOV_BYTES;
            const float* lse_c = rows_of(st);
            const float* dl_c = lse_c + BM;
            const int p0 = q_offset + r0;
            // every key of the warpgroup seen by every one of the 64 rows
            // (none of which is then a row that sees no key)
            const bool interior = r0 + BM <= S && kw0 + 64 <= T
                                  && (!causal || kw0 + 63 <= p0)
                                  && (window <= 0
                                      || kw0 > p0 + BM - 1 - window);
            wgmma_wait<1>();
            fence_regs(s);
            // element e: key a or b by (e >> 1) & 1, q row r0 + 8 (e / 4)
            // + 2 (lane % 4) + (e & 1)
            uint32_t blind = 0;     // bit e: its row sees no key
            if (interior) {
#pragma unroll
                for (int e = 0; e < 32; ++e) {
                    const int col = 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
                    s[e] = ex2(fmaf(s[e], scale_log2, -lse_c[col]));
                }
            } else {
#pragma unroll
                for (int e = 0; e < 32; ++e) {
                    const int col = 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
                    const int row = r0 + col;
                    const int p = q_offset + row;
                    const int key = ((e >> 1) & 1) ? key_b : key_a;
                    const bool in = row < S && key < T;
                    const bool none = window > 0 && p >= p_blind;
                    const bool vis = in && (!causal || key <= p)
                                     && (window <= 0 || key > p - window);
                    blind |= (uint32_t)(none && row < S) << e;
                    s[e] = none ? (in ? inv_t : 0.0f)
                                : vis ? ex2(fmaf(s[e], scale_log2,
                                                 -lse_c[col]))
                                      : 0.0f;
                }
            }
            // dS^T in dP^T's place
            wgmma_wait<0>();
            fence_regs(dp);
#pragma unroll
            for (int e = 0; e < 32; ++e) {
                const int col = 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
                dp[e] = (blind >> e) & 1u ? 0.0f
                                          : s[e] * (dp[e] - dl_c[col]);
            }
            if constexpr (SPLIT) {
                // P^T.dO (dv) or dS^T.Q (dk): the same instructions in
                // both warpgroups on operands selected by the warpgroup
                // (no divergent path around the products)
#pragma unroll
                for (int e = 0; e < 32; ++e) s[e] = w ? dp[e] : s[e];
                split_frags(s, a_hi[0], a_lo[0]);
                wgmma_fence();
                wgmma_parts<D, BM>(acc, a_hi[0], a_lo[0], w ? s_q : s_do);
            } else {
                split_frags(s, a_hi[0], a_lo[0]);
                split_frags(dp, a_hi[1], a_lo[1]);
                wgmma_fence();
                wgmma_parts<D, BM>(acc_v, a_hi[0], a_lo[0], s_do);  // dV
                wgmma_parts<D, BM>(acc, a_hi[1], a_lo[1], s_q);     // dK
            }
            wgmma_commit();
        };
        mbar_wait(bar, 0);
        if (n_items > 0) {
            wgmma_fence();
            issue_sdp(0);
            // item i + 1's S^T and dP^T issued under item i's second
            // products
            for (int i = 0; i + 1 < n_items; ++i) {
                step(i);
                issue_sdp(i + 1);
                wgmma_wait<2>();
                fence_regs(acc);
                fence_regs(acc_v);
                if (lane == 0) mbar_arrive(empty(i % DEPTH));
            }
            step(n_items - 1);
            wgmma_wait<0>();
            fence_regs(acc);
            fence_regs(acc_v);
            if (lane == 0) mbar_arrive(empty((n_items - 1) % DEPTH));
        }
"""


def replace(src, old, new):
    if src.count(old) != 1:
        raise SystemExit(f"k4_bwd_tc_variants: anchor not found once: "
                         f"{old[:60]!r}")
    return src.replace(old, new)


def between(src, start, end, new):
    """``src`` with the text from ``start`` (inclusive) up to ``end``
    (kept) replaced by ``new``; each anchor once."""
    for anchor in (start, end):
        if src.count(anchor) != 1:
            raise SystemExit(f"k4_bwd_tc_variants: anchor not found once: "
                             f"{anchor[:60]!r}")
    i = src.index(start)
    return src[:i] + new + src[src.index(end, i):]


KV_KEYS = "return D >= 128 ? 64 : 128;"
SPLIT = "constexpr bool SPLIT = D >= 128;"


def overlap(src):
    src = between(src, DQ_START, DQ_END, OVERLAP_DQ)
    return between(src, KV_START, KV_END, OVERLAP_KV)


def cap_interior(src):
    """dq's CAP tiles on the interior path where every one of the 64
    rows sees every key, as a tile without a cap."""
    return replace(replace(src, DQ_INTERIOR,
                           DQ_INTERIOR.replace("if (!CAP && ", "if (")),
                   DQ_INTERIOR_LOOP, DQ_INTERIOR_CAP)


def cap_kv_masked(src):
    """dkdv's CAP items all on the masked path, as dq's CAP tiles."""
    return replace(replace(src, KV_INTERIOR,
                           KV_INTERIOR.replace("if (", "if (!CAP && ")),
                   KV_INTERIOR_CAP, KV_INTERIOR_LOOP)


def cap_wait_both(src):
    """dkdv's earlier CAP item: both products waited on, P^T
    and dS^T formed together from one r, then the second products one
    after the other as without a cap."""
    src = replace(replace(cap_kv_masked(src), KV_DTANH, KV_WAIT_BOTH),
                  KV_CAP, KV_CAP_TOGETHER)
    src = replace(src, KV_DK_MUL, "const float dk_mul = scale;")
    src = replace(src, KV_TAIL_SELECT, KV_TAIL_SELECT.replace(
        "if constexpr (!CAP)", "if constexpr (true)"))
    return between(src, KV_CAP_PRODUCTS, KV_PLAIN_PRODUCTS,
                   "            uint32_t hi[4][4], lo[4][4];\n"
                   "            if constexpr (SPLIT) {\n").replace(
        KV_PLAIN_PRODUCTS, "", 1)


def tanhf(src):
    """The capped pair as PR 33 wrote it: t = tanhf(s * scale / cap) and
    1 - t^2 in dq and dkdv (dkdv's item as ``cap_wait_both``)."""
    src = replace(replace(cap_wait_both(src), DQ_CAP, DQ_TANHF),
                  KV_CAP_TOGETHER, KV_TANHF)
    if src.count(CAP_K2) != 2:
        raise SystemExit("k4_bwd_tc_variants: the launches' k2 not found "
                         "twice")
    return src.replace(CAP_K2, SC_CAP)


# name -> (patch of the source text, whether it is checked)
VARIANTS = {
    "v0": (lambda src: src, True),
    "masks_always": (lambda src: replace(
        replace(src, DQ_INTERIOR,
                DQ_INTERIOR.replace("if (!CAP && ", "if (false && ")),
        KV_INTERIOR, KV_INTERIOR.replace("if (", "if (false && ")), True),
    "cap_interior": (cap_interior, True),
    "cap_wait_both": (cap_wait_both, True),
    "cap_late_dv": (lambda src: replace(src, KV_EARLY_DV, KV_LATE_DV), True),
    "cap_kv_masked": (cap_kv_masked, True),
    "cap_split_wait": (lambda src: replace(src, KV_DTANH, KV_DTANH + (
        KV_WAIT_BOTH.replace("if constexpr (CAP)",
                             "if constexpr (CAP && SPLIT)"))), True),
    "tanhf": (tanhf, True),
    "one_part": (lambda src: replace(src, LO_PRODUCT, ""), False),
    "both_products": (lambda src: replace(src, SEQUENTIAL, BOTH), True),
    "overlap": (overlap, True),
    "kv64": (lambda src: replace(replace(src, KV_KEYS, "return 64;"),
                                 SPLIT, "constexpr bool SPLIT = true;"),
             True),
}


# the pair's softcap launches (flash_attention_bwd_tc_softcap.cu after
# its include of flash_attention_bwd_tc.cu), appended to a variant's text
CAPPED = (SOURCE.parent / "flash_attention_bwd_tc_softcap.cu").read_text() \
    .split('#include "flash_attention_bwd_tc.cu"', 1)[1]


def with_softcap(src):
    """``src`` and, where it declares them, its softcap instantiations
    (one translation unit)."""
    return src + CAPPED if "fb_tc_dq_softcap" in src else src


def patched(name):
    """The variant's source text."""
    return VARIANTS[name][0](SOURCE.read_text())


def build(sources):
    """name -> library path; prints each kernel's registers, spills and
    ptxas's C75xx notes."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, text in sources.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(with_softcap(text))
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-Xptxas", "-v", "-o",
             str(OUT / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"k4_bwd_tc_variants: {name} failed to build:"
                             f"\n{out}")
        kernels = re.findall(
            r"Compiling entry function '_Z\S*?(fa_bwd_\w+?_kernel)I"
            r"\S*?Li(\d+)E\S*'.*?(\d+) bytes spill stores.*?Used (\d+) "
            r"registers", out, re.S)
        notes = sorted(set(re.findall(r"\((C75\d\d)\)[^']*'_Z\S*?"
                                      r"(fa_bwd_\w+?_kernel)I\S*?Li(\d+)",
                                      out)))
        print(json.dumps({"variant": name, "ptxas": [
            {"kernel": k, "d": int(d), "spill_stores": int(sp),
             "registers": int(r)} for k, d, sp, r in kernels],
            "notes": notes}), flush=True)
    return {name: OUT / f"lib{name}.so" for name in sources}


def use(path):
    """Route the wrapper's bf16 pair to the library at ``path``; return
    it."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    import torch
    lib = ctypes.CDLL(str(path))
    lib.flash_attention_bwd_dq_bf16.argtypes = fa._BWD_DQ_BF16_ARGTYPES
    lib.flash_attention_bwd_dkdv_bf16.argtypes = fa._BWD_ARGTYPES
    lib.flash_attention_bwd_dq_bf16.restype = ctypes.c_int
    lib.flash_attention_bwd_dkdv_bf16.restype = ctypes.c_int
    _build._LIBS[fa._BWD_SOURCES[torch.bfloat16]] = lib
    return lib


def check(smoke, libs, names, capped=False):
    """Each checked variant on ``BF16_BWD_CASES`` (``capped``: on
    ``softcap_bwd_checks``' bf16 cases, ``check_softcap_bwd``); returns
    name -> {case: errors or the failure}, and whether every one
    passed."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(33)

    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    inputs = []
    if capped:
        bf16 = torch.bfloat16
        for d in smoke.HEAD_DIMS:
            for b, s, t, h, hkv, causal, window, off in smoke.SOFTCAP_MASKS:
                q, do, k, v = (r(b, s, h, d), r(b, s, h, d), r(b, t, hkv, d),
                               r(b, t, hkv, d))
                for cap in smoke.SOFTCAP_CAPS:
                    inputs.append((
                        f"d{d}-{causal}-w{window}-off{off}-cap{cap:g}",
                        ((q * (2 * cap)).to(bf16), k.to(bf16), v.to(bf16),
                         do.to(bf16), cap),
                        dict(causal=causal, window=window, q_offset=off)))
    else:
        for case, (b, s, t, h, hkv, d), kw in smoke.BF16_BWD_CASES:
            inputs.append((case, (r(b, s, h, d), r(b, t, hkv, d),
                                  r(b, t, hkv, d), r(b, s, h, d)), kw))
    run = smoke.check_softcap_bwd if capped else smoke.check_flash_bwd_bf16
    out, ok = {}, True
    for name in names:
        if name in VARIANTS and not VARIANTS[name][1]:
            continue
        use(libs[name])
        out[name] = {}
        for case, ins, kw in inputs:
            try:
                row = run(case, *ins, **kw)
                out[name][case] = {k: row[k] for k in row
                                   if k.endswith("_max_abs_err")}
            except SystemExit as e:
                out[name][case] = {"failed": str(e)}
                ok = False
        print(json.dumps({"variant": name, "checks": out[name]}),
              flush=True)
    return out, ok


def times(smoke, libs, names, cap=0.0):
    """(dq ms, dkdv ms, the pair's ms through the wrapper) of each
    variant at each layer with the logit softcap ``cap`` (0: none), in
    turns."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    bf16 = torch.bfloat16
    res = {}
    for arch, qs, ks, window in smoke.FA_BWD_BF16_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(35)
        q, do = (torch.randn(qs, generator=gen, device="cuda").to(bf16)
                 for _ in "qd")
        k, v = (torch.randn(ks, generator=gen, device="cuda").to(bf16)
                for _ in "kv")
        o, lse, o_lo = fa._kernel_forward(q, k, v, True, window, 0,
                                          with_lse=True, softcap=cap)
        b, s, h, d = qs
        t, hkv = ks[1], ks[2]
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        delta = torch.empty((b, h, s), device="cuda")
        args = (b, s, t, h, hkv, d, 1, window, 0, 1.0 / math.sqrt(d))
        res[arch] = {n: {"dq": [], "dkdv": [], "pair": []} for n in names}
        for name in list(names) + list(reversed(names)):
            lib = use(libs[name])

            def dq_kernel():
                lib.flash_attention_bwd_dq_bf16(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    o_lo.data_ptr(), do.data_ptr(), lse.data_ptr(),
                    delta.data_ptr(), dq.data_ptr(), *args,
                    torch.cuda.current_stream().cuda_stream, cap)

            def dkdv_kernel():
                lib.flash_attention_bwd_dkdv_bf16(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), *args,
                    torch.cuda.current_stream().cuda_stream, cap)

            def pair():
                return fa._kernel_backward(q, k, v, o, lse, do, True,
                                           window, 0, o_lo, cap)

            dq_kernel()                    # delta for the dkdv timing
            res[arch][name]["dq"].append(
                smoke.median_ms(dq_kernel, runs=5, per_run=5))
            res[arch][name]["dkdv"].append(
                smoke.median_ms(dkdv_kernel, runs=5, per_run=5))
            res[arch][name]["pair"].append(
                smoke.median_ms(pair, runs=5, per_run=5))
        print(json.dumps({"arch": arch, "ms_turns": res[arch]}), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=",".join(VARIANTS),
                    help="comma-separated variants (default: all)")
    ap.add_argument("--baseline", action="append", default=[],
                    help="NAME=FILE.cu: another source as variant NAME")
    ap.add_argument("--softcap", type=float, default=0.0,
                    help="time with this logit softcap (the CAP kernels) "
                         "and check on the capped cases")
    args = ap.parse_args(argv)
    names = [n for n in args.only.split(",") if n]
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"k4_bwd_tc_variants: unknown {unknown}")
    sources = {n: patched(n) for n in names}
    for spec in args.baseline:
        name, _, path = spec.partition("=")
        if not name or not path or name in sources:
            raise SystemExit(f"k4_bwd_tc_variants: --baseline {spec!r}: "
                             f"want a new NAME=FILE.cu")
        sources[name] = Path(path).read_text()
    import torch
    if not torch.cuda.is_available():
        print("k4_bwd_tc_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from repro_torch import set_full_f32
    set_full_f32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    libs = build(sources)
    names = list(sources)
    checks, ok = check(smoke, libs, names, capped=args.softcap > 0)
    res = times(smoke, libs, names, args.softcap)
    least = {arch: {n: {k: min(v) for k, v in r.items()}
                    for n, r in per.items()} for arch, per in res.items()}
    print(json.dumps({"card": card, "softcap": args.softcap,
                      "least_ms": least, "checks_passed": ok,
                      "checked": sorted(checks)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
