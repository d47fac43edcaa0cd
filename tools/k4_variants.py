#!/usr/bin/env python3
"""Variants of the bf16 attention kernel (K4) on one GPU, timed in turns.

    python3 tools/k4_variants.py [--only v0,bq192,...] [--prefill]

Each variant is the committed ``src/repro_torch/kernels/csrc/
flash_attention.cu`` with text patches and ``-D`` switches, built with
``nvcc -Xptxas -v`` into ``build/k4_variants/`` (registers and spills are
printed).  The variants that compute attention are held against
``gqa_plain`` on the edge cases of ``chip_smoke.py``, at the bf16
tolerance (rtol 8e-3, atol 1e-3; ``p_single``, which rounds P to bf16
once, at its own atol 3e-3); the ablations (parts switched off) only
run.  All are timed with ``chip_smoke.median_ms`` (launches enqueued
behind other device work, so the reading is device time) at the three
prefill shapes of ``chip_smoke.py``, in turns: v0 first, then each
variant, then the order reversed.  With ``--prefill``, each checked
variant also runs ``chip_smoke.bf16_prefill_vs_f32`` (the bf16 hymba
1280-token prefill, with the variant and with ``gqa_plain``, against the
f32 forward on the same weights).  The last line of standard output is
one JSON object of the times.  Needs one CUDA card and nvcc; exits
non-zero otherwise or when a checked variant disagrees.  The variants
are of the head dims up to 64 (the cases and shapes are all there): the
``serial`` consumer keeps 128-key tiles, which the D = 128 and 192
instantiations (64-key tiles) do not use, so those compile in every
variant but compute attention only in v0 and the variants that keep
the committed consumer.

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
  no_softmax          (ablation) products, no softmax
  no_products         (ablation) softmax on stale scores, no products
  loads_only          (ablation) the TMA ring and barriers alone
  loads_only_bq192    (ablation) the same at 192 rows
"""

from __future__ import annotations

import argparse
import ctypes
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
SHAPES = {"hymba-4096-window1024": (2, 4096, 25, 5, 1024),
          "hymba-1024-causal": (2, 1024, 25, 5, 0),
          "llama-4096-causal": (2, 4096, 32, 8, 0)}


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
    return replace(src, """        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);""",
                   """#ifdef FA_L2_256
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
#else
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
#endif
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);""")


def no_turns(src):
    """Overlap without ping-pong: the turn barriers go."""
    src = replace(src, """            asm volatile("bar.sync %0, 256;\\n" :: "r"(3 + w) : "memory");""", "")
    src = replace(src, """            asm volatile("bar.arrive %0, 256;\\n" :: "r"(4 - w) : "memory");""", "")
    src = replace(src, """        if (w == 1)
            asm volatile("bar.arrive 3, 256;\\n" ::: "memory");""", "")
    return replace(src, """        if (w == 0)
            asm volatile("bar.sync 3, 256;\\n" ::: "memory");""", "")


def branching_turns(src):
    """Ping-pong whose last turn of warpgroup 1 skips its arrival (a
    branch between issue and wait; ptxas serializes: C7520)."""
    src = replace(src, """        auto turn_end = [&]() {
            asm volatile("bar.arrive %0, 256;\\n" :: "r"(4 - w) : "memory");
        };""", """        const int n_turns = n_tiles + 1;
        int turn = 0;
        auto turn_end = [&]() {
            if (!(w == 1 && turn == n_turns - 1))
                asm volatile("bar.arrive %0, 256;\\n" :: "r"(4 - w)
                             : "memory");
            ++turn;
        };""")
    return replace(src, """        if (w == 0)
            asm volatile("bar.sync 3, 256;\\n" ::: "memory");""", "")


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
                softmax_tile<false>(s, m, l, corr, scale_log2, t0, T,
                                    row_pos, causal, window);
            else
                softmax_tile<true>(s, m, l, corr, scale_log2, t0, T,
                                   row_pos, causal, window);
        };""", """#ifndef ABL_NOSOFTMAX
            if (interior)
                softmax_tile<false>(s, m, l, corr, scale_log2, t0, T,
                                    row_pos, causal, window);
            else
                softmax_tile<true>(s, m, l, corr, scale_log2, t0, T,
                                   row_pos, causal, window);
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
    "no_softmax": ((ablations,), ("-DABL_NOSOFTMAX",), None),
    "no_products": ((ablations,), ("-DABL_NOQK", "-DABL_NOPV"), None),
    "loads_only": ((ablations,), ("-DABL_NOQK", "-DABL_NOPV",
                                  "-DABL_NOSOFTMAX"), None),
    "loads_only_bq192": ((no_turns, knobs, ablations),
                         ("-DFA_NWG=3", "-DABL_NOQK", "-DABL_NOPV",
                          "-DABL_NOSOFTMAX"), None),
}


def build(names):
    """Build every named variant in parallel; name -> (library, ptxas
    lines)."""
    from repro_torch.kernels import _build
    committed = (_build.CSRC / "flash_attention.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        patches, defines, _ = VARIANTS[name]
        src = committed
        for patch in patches:
            src = patch(src)
        cu = OUT / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-Xptxas", "-v",
             "-o", str(OUT / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k4_variants: {name} failed to build:\n{out}")
        keep = [ln.strip() for ln in out.splitlines()
                if "tc_kernel" in ln or "registers" in ln or "spill" in ln
                or "C75" in ln]
        libs[name] = (ctypes.CDLL(str(OUT / f"lib{name}.so")), keep)
    return libs


def use(lib):
    """Route ``flash_attention`` to ``lib``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    lib.flash_attention_fwd.argtypes = fa._ARGTYPES
    lib.flash_attention_fwd.restype = ctypes.c_int
    _build._LIBS["flash_attention"] = lib


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


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(VARIANTS),
                    help="comma-separated variants (v0 is always built)")
    ap.add_argument("--prefill", action="store_true",
                    help="also the bf16 hymba prefill against the f32 "
                         "forward, with each checked variant")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k4_variants: no CUDA device", file=sys.stderr)
        return 1
    names = ["v0"] + [n for n in args.only.split(",") if n and n != "v0"]
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"k4_variants: unknown variants {unknown}")
    import chip_smoke
    from repro_torch.kernels import flash_attention as fa
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    libs = build(names)
    for name in names:
        print(json.dumps({"variant": name, "ptxas": libs[name][1]}),
              flush=True)
    gen = torch.Generator(device="cuda").manual_seed(10)
    checks = cases(gen)
    bad = []
    for name in names:
        tol = VARIANTS[name][2]
        if tol is None:
            continue
        use(libs[name][0])
        worst = 0.0
        for cname, (q, k, v), kw in checks:
            want = fa.gqa_plain(q, k, v, **kw)
            got = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            worst = max(worst, err)
            if not torch.allclose(got.float(), want.float(), rtol=tol[0],
                                  atol=tol[1]):
                bad.append(f"{name}/{cname}: max abs {err}")
        print(json.dumps({"variant": name, "checked": len(checks),
                          "worst_max_abs_err": worst, "tol": tol}),
              flush=True)
    times = {}
    for shape, (b, s, h, hkv, window) in SHAPES.items():
        def r(*shape_):
            return torch.randn(*shape_, generator=gen,
                               device="cuda").to(torch.bfloat16)
        q, k, v = r(b, s, h, 64), r(b, s, hkv, 64), r(b, s, hkv, 64)
        times[shape] = {}
        for name in names + names[::-1]:
            use(libs[name][0])
            times[shape].setdefault(name, []).append(chip_smoke.median_ms(
                lambda: fa.flash_attention(q, k, v, window=window),
                runs=5, per_run=10))
        print(json.dumps({"shape": shape, "ms": times[shape]}), flush=True)
    prefill = {}
    if args.prefill:
        cfg, params = chip_smoke._lm_params("hymba-1.5b", torch.bfloat16)
        for name in names:
            if VARIANTS[name][2] is not None:
                use(libs[name][0])
                prefill[name] = chip_smoke.bf16_prefill_vs_f32(cfg, params)
                print(json.dumps({"variant": name,
                                  "prefill_vs_f32": prefill[name]}),
                      flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "failed": bad, "ms": times,
                      "prefill_vs_f32": prefill}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
