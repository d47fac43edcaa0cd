// The backward of K4 on bf16 inputs for Hopper (sm_90a): two
// warp-specialised kernels whose products are wgmma with f32
// accumulators, their moving tiles fed by TMA.  flash_attention_bwd.cu
// holds the f32 pair (split TF32 on mma.sync) and states the function:
//
//   q, o, o_lo, dO (B,S,H,D) bf16, k, v (B,T,Hkv,D) bf16, contiguous on
//   16-byte addresses; lse (B,H,S) f32 from the forward.
//   s_ij    = (q_i . k_j) * scale, visible by the forward's masks
//             (causal, window, q_offset; absolute positions)
//   P_ij    = exp(s_ij - lse_i) if visible, else 0
//   delta_i = sum_d dO_id * (o_id + o_lo_id)   (o + o_lo: the forward's f32
//             output to about 2^-16, as autograd of the f32 softmax takes it)
//   dS_ij   = P_ij * (dO_i . v_j - delta_i)
//   dq_i = scale sum_j dS_ij k_j;  dk_j = scale sum_{h in group} sum_i dS_ij q_i;
//   dv_j = sum_{h in group} sum_i P_ij dO_i
//   A row that sees no key has P = 1/T on every key and dS = 0.
//
// With a logit softcap (the CAP instantiations, built in
// flash_attention_bwd_tc_softcap.cu, which includes this file with
// FB_TC_KERNELS_ONLY and is linked into its library), each score is
// capped as the bf16 forward's softmax_tile caps it, by the same
// branch-free fa_hopper.cuh: softcap_r and constants: r = 1 / (1 +
// 2^(s * k2)), k2 = 2 log2 e * scale / cap, t = tanh(s * scale / cap)
// = 1 - 2r, and P = 2^(cap_log2 (1 - 2r) - lse log2 e), cap_log2 = cap
// * log2 e, so P is of the capped score the forward's lse summed; dS =
// P (dP - delta) (1 - t^2) with 1 - t^2 = 4 r (1 - r), the factor
// entering before dS's two-part split.  dq forms P (1 - t^2) in P's
// place (it needs no P alone), its 4 in the exponent, and takes every
// CAP tile on the masked path (an interior path read 3-5 % slower: the
// masks' integer work hides under the SFU work).  dkdv needs both P and
// dS: a CAP item forms P^T, and keeps r (1 - r) in a register array (the
// 4 in dk's scale), under dP^T's product, as an item without a cap forms
// P^T, and an interior item does so without the masks (its masks cost
// dkdv 12-39 %); below D = 128 it issues dV += P^T.dO as soon as P^T is
// split and forms dS^T under that product into a second set of parts,
// then issues dK (32 registers of r (1 - r) and 32 of parts more than
// without a cap); from D = 128 the warpgroup that sums dv forms no
// dS^T.
//
// The JAX package has no backward Pallas kernel (JAX differentiates the
// jnp attention); the port's gradient through its forward kernel needs
// one.  No float atomics: every output element is summed by one thread
// in a fixed order, so a gradient is the same bits every run.
//
// Bound.  Per visible (q, k) pair of a head, five D-long dots (10*D
// flops) and one exp; at 989e12 bf16 flop/s the tensor cores bound the
// pair far above the bytes (q, k, v, o, o_lo, dO read, dq, dk, dv
// written once).  This design computes S and dP in both kernels and
// carries P and dS as two bf16 parts each (below): 4 dots a pair in dq
// and 6 in dkdv (8 at D = 128 and 192), 10 (12) in all.
//
// Shape (FA3's backward, without its dq atomics): a block is three
// warpgroups of 128 threads.  Warpgroup 0 is the producer (setmaxnreg
// 24): one thread loads the block's stationary tiles once and keeps the
// moving tiles in flight by TMA in a ring of DEPTH stages, each stage
// with a full and an empty mbarrier (its warp also copies dkdv's lse and
// delta rows, whose (B,H,S) f32 rows are no multiple of 16 bytes and so
// no TMA box).  Warpgroups 1 and 2 consume (setmaxnreg 240), 64
// stationary rows each.  Tiles sit in shared memory in fa_hopper.cuh's
// swizzled column blocks (Tiles<D>), the layout TMA writes and wgmma
// reads; the maps are 4-D over (D, rows, heads, batch) and TMA's
// out-of-bounds fill gives the zero rows past S and T.
//
//   dq (fa_bwd_tc_dq_kernel): one block a (128 q rows, q head, b), the
//     last q tiles first (under a causal mask they see the most keys).
//     Q and dO are stationary; K and V tiles of BK = 64 keys move, over
//     the keys the block's rows see (the union of their bands; rows that
//     see no key give dS = 0 and take none).  A warpgroup first takes
//     delta of its 64 rows from o, o_lo and dO (two threads a row) and
//     writes it for dkdv, then for each tile of its own rows' run:
//       S = Q.K^T and dP = dO.V^T, wgmma m64n64k16, both operands
//         K-major from shared memory, D/16 k-steps, two commit groups
//         (P is formed from S while dP is on the tensor cores);
//       P = 2^(S * scale log2 e - lse log2 e) and dS = P (dP - delta)
//         on the accumulator fragments, masked by select;
//       dQ += dS.K: dS split into dS_hi = bf16(dS) and dS_lo = bf16(dS -
//         dS_hi), register A operands (the m64nN accumulator's layout is
//         the A fragment's of the next k16 slice), K an MN-major B
//         operand (the transpose bit, as the forward's P.V reads V), one
//         m64nDk16 each a 16-key slice.
//     dq is scaled and rounded to bf16 once, written by the thread that
//     summed it.  Tiles outside a warpgroup's run are released unread.
//     A tile whose every key all 64 rows see skips the masks.
//   dkdv (fa_bwd_tc_dkdv_kernel): one block a (128 keys, kv head, b;
//     64 keys from D = 128 on, below),
//     the first key tiles first.  K and V are stationary, 64 keys a
//     warpgroup; the moving items are (q tile of BM = 64 rows, q head
//     of the group) in a fixed order: the tiles whose rows see one of
//     the block's keys, then the tiles of rows that see no key (fb_walk
//     of flash_attention_bwd.cu), each for every head of the group; an
//     item brings Q, dO and the rows' lse and delta.  For each item:
//       S^T = K.Q^T and dP^T = V.dO^T, wgmma m64n64k16 (K-major);
//       P^T and dS^T on the fragments: the accumulator's rows are keys,
//         its columns q rows, each thread reading the lse and delta of
//         the 16 columns it holds from the stage;
//       dV += P^T.dO and dK += dS^T.Q, P^T and dS^T as two bf16 parts
//         each (register A operands: the accumulator of S^T is already
//         the A fragment whose contraction runs over q rows, no
//         transpose through shared memory), dO and Q MN-major B operands.
//     dk and dv stay in registers over all items (the group's heads
//     summed there) and are written once, dk scaled.  An item whose
//     rows all see every key of the warpgroup skips the masks: their
//     integer work per element held dkdv at 0.325 ms at hymba's layer,
//     0.187 without it on the interior items (tools/k4_bwd_tc_variants.py:
//     masks_always).
//     Each item's second products go one after the other (dV, wait,
//     dK), so that the parts of one operand, dk, dv and S^T, dP^T fit a
//     consumer's 240 registers (both at once spilled at D = 128).
//   D = 128 and 192: dk and dv of 64 keys take 128 (192) of a
//     consumer's 240 registers, and with S^T, dP^T and the parts ptxas
//     spilled at D = 128 and serialized the products (C7512), so a
//     block takes 64 keys and splits the outputs between its
//     warpgroups: both form S^T, dP^T, P^T and dS^T, and warpgroup 1
//     sums dv += P^T.dO, warpgroup 2 dk += dS^T.Q, the same
//     instructions on operands selected by the warpgroup (a branch
//     around the products made ptxas serialize them, C7520): 8 dots a
//     pair.
//
// A warpgroup runs each tile's or item's products in series (first
// products, wait, second products, wait); the other warpgroup's products
// fill the tensor cores meanwhile.  Issuing the next item's S and dP
// under this item's second products (FA3's overlap within a warpgroup)
// read 19-30 % slower at hymba's, llama's and phi4-mini's layers on an
// H100 (tools/k4_bwd_tc_variants.py: overlap).
//
// Rounding.  S and dP are exact sums of exact products of bf16 values,
// in f32.  P and dS enter the second products as two bf16 parts (x to
// about 2^-16, as the forward carries P): one bf16 part (2^-9) misses
// the bf16 tolerance (rtol 8e-3, atol 1e-3 * max(1, max |want|)) in all
// three gradients, by up to 1.8x (tests/test_torch_k4_bf16_wgmma_bwd.py
// emulates this schedule both ways); the second part costs one more
// wgmma on the same B descriptor, 14 % of dq's time and 24 % of dkdv's
// at llama's layer on an H100 (tools/k4_bwd_tc_variants.py: one_part).  The gradients are summed in the
// wgmma accumulators and rounded once to bf16.  exp goes through
// ex2.approx.
//
// Shared memory (bytes): dq Q, dO 2*128*2*D, ring DEPTH*(K, V of 64
// keys), delta 512; dkdv K, V 2*128*2*D (64 keys from D = 128), ring
// DEPTH*(Q, dO of 64 rows), DEPTH*512 of lse and delta.  DEPTH is 3
// where it fits, else 2 (dq at D = 192); flash_attention_bwd_tc_sizes
// reports each launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fa_hopper.cuh"     // TMA, mbarriers, wgmma, tensor maps

namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 128;          // q rows a dq block: two warpgroups
constexpr int BK = 64;           // keys a dq stage
constexpr int BM = 64;           // q rows a dkdv stage
constexpr int THREADS = 384;     // producer warpgroup + 2 consumers
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr float LOG2E = 1.4426950408889634f;

// keys a dkdv block: a warpgroup's 64 each, or from D = 128 on one
// 64-key tile that both warpgroups take (dv in one, dk in the other)
template <int D>
__host__ __device__ constexpr int kv_keys() { return D >= 128 ? 64 : 128; }

// The shared memory of one kernel at head dim D: two stationary tiles
// of FIX rows (dq: Q, dO; dkdv: K, V), a ring of DEPTH stages of two
// moving tiles of MOV rows (dq: K, V; dkdv: Q, dO), dkdv's lse and
// delta rows of each stage (dq: its rows' delta), then the mbarriers:
// fix, and full and empty of every stage.
template <int D, bool DKDV>
struct Bwd : Tiles<D> {
    static constexpr int FIX = DKDV ? kv_keys<D>() : BQ;
    static constexpr int MOV = DKDV ? BM : BK;
    static constexpr int FIX_BYTES = FIX * 2 * D;
    static constexpr int MOV_BYTES = MOV * 2 * D;
    static constexpr int DEPTH =
        2 * FIX_BYTES + 3 * 2 * MOV_BYTES + 4096 <= 227 * 1024 ? 3 : 2;
    static constexpr int ROWS_BYTES = DKDV ? 2 * BM * 4 : 0;  // a stage
    static constexpr int A_OFF = 0;                       // Q or K
    static constexpr int B_OFF = FIX_BYTES;               // dO or V
    static constexpr int RING_OFF = 2 * FIX_BYTES;        // stage: 2 tiles
    static constexpr int ROWS_OFF = RING_OFF + DEPTH * 2 * MOV_BYTES;
    static constexpr int BAR_OFF =
        ROWS_OFF + (DKDV ? DEPTH * ROWS_BYTES : BQ * 4);
    static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * DEPTH);
    static constexpr int ALLOC = BYTES + 1024;            // room to align
    static_assert(FIX_BYTES % 1024 == 0 && MOV_BYTES % 1024 == 0, "tiles");
    static_assert(ALLOC <= 227 * 1024, "shared memory");
};

// the keys absolute position p sees: [lo, hi) (empty when hi <= lo)
__device__ __forceinline__ void band(int p, int T, int causal, int window,
                                     int& lo, int& hi) {
    lo = window > 0 ? max(0, p - window + 1) : 0;
    hi = causal ? min(T, p + 1) : T;
}

// The keys rows [r0, r1) see, over those < S that see a key: [lo, hi),
// empty (hi <= lo) when none does.  A row sees no key only under a
// window, from p = T + window - 1 on, and the bands' ends grow with p,
// so the union is [lo(first row), hi(last row that sees a key)).
__device__ __forceinline__ void rows_band(int r0, int r1, int S, int T,
                                          int causal, int window,
                                          int q_offset, int& lo, int& hi) {
    r1 = min(r1, S);
    if (window > 0) r1 = min(r1, T + window - 1 - q_offset);
    if (r1 <= r0) {
        lo = T;
        hi = 0;
        return;
    }
    int unused;
    band(q_offset + r0, T, causal, window, lo, unused);
    band(q_offset + r1 - 1, T, causal, window, unused, hi);
}

// acc (64 x D, f32) += A (64 x 16, registers) . B (16 x D, shared,
// MN-major): B's 16 rows from s_b in a tile of ROWS rows, whose column
// blocks lie ROWS rows apart (the descriptor's leading byte offset above
// D = 64)
template <int D, int ROWS>
__device__ __forceinline__ void wgmma_rs_d(float (&acc)[D / 2],
                                           const uint32_t (&a)[4],
                                           uint32_t s_b) {
    using L = Tiles<D>;
    const uint64_t desc = make_desc(s_b, D > 64 ? ROWS * L::ROW : L::ATOM,
                                    L::ATOM, L::SWIZZLE);
    if constexpr (D == 16) wgmma_m64n16k16_rs(acc, a, desc);
    else if constexpr (D == 32) wgmma_m64n32k16_rs(acc, a, desc);
    else if constexpr (D == 64) wgmma_m64n64k16_rs(acc, a, desc);
    else if constexpr (D == 80) wgmma_m64n80k16_rs(acc, a, desc);
    else if constexpr (D == 128) wgmma_m64n128k16_rs(acc, a, desc);
    else wgmma_m64n192k16_rs(acc, a, desc);
}

// acc (64 x 64) = A (64 rows of a tile of A_ROWS at s_a) . B^T (64 rows
// of a tile of B_ROWS at s_b), both D wide, K-major: D/16 k-steps
template <int D, int A_ROWS, int B_ROWS>
__device__ __forceinline__ void wgmma_abt(float (&acc)[32], uint32_t s_a,
                                          uint32_t s_b) {
    using L = Tiles<D>;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16_ss(
            acc,
            make_desc(s_a + L::kstep(kk, A_ROWS), 16, L::ATOM, L::SWIZZLE),
            make_desc(s_b + L::kstep(kk, B_ROWS), 16, L::ATOM, L::SWIZZLE),
            kk > 0);
}

// a 64 x 64 accumulator as the A operands of its four 16-column slices,
// each value split into two bf16 parts (hi + lo, about 2^-16)
__device__ __forceinline__ void split_frags(const float (&c)[32],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q)
            split_bf16(c[8 * kk + 2 * q], c[8 * kk + 2 * q + 1], hi[kk][q],
                       lo[kk][q]);
}

// acc += (hi + lo) . B, B the MOV-row tile at s_b (MN-major): two
// products a 16-row slice on one descriptor
template <int D, int ROWS>
__device__ __forceinline__ void wgmma_parts(float (&acc)[D / 2],
                                            const uint32_t (&hi)[4][4],
                                            const uint32_t (&lo)[4][4],
                                            uint32_t s_b) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        const uint32_t s = s_b + kk * 16 * Tiles<D>::ROW;
        wgmma_rs_d<D, ROWS>(acc, hi[kk], s);
        wgmma_rs_d<D, ROWS>(acc, lo[kk], s);
    }
}

// The accumulator (64 x D) of a warpgroup's rows, scaled and rounded
// once to bf16, into rows [r0, r0 + 64) < n of a (rows, heads, D) slab
// at out (row stride `stride` elements)
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[D / 2],
                                           float mul, int r0, int n,
                                           long long stride, int warp,
                                           int lane) {
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
        const int r = r0 + 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
        const int col = 8 * (i >> 2) + 2 * (lane & 3);
        if (r < n)
            *reinterpret_cast<__nv_bfloat162*>(out + r * stride + col) =
                __floats2bfloat162_rn(acc[i] * mul, acc[i + 1] * mul);
    }
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) a[i] = 0.0f;
}

// ---- dq ------------------------------------------------------------------

// CAP: with a logit softcap (k2, cap_log2 read only then)
template <int D, bool CAP>
__global__ void __launch_bounds__(THREADS, 1)
fa_bwd_tc_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const bf16* __restrict__ o, const bf16* __restrict__ o_lo,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    bf16* __restrict__ dq, int S, int T, int H, int Hkv,
                    int causal, int window, int q_offset, float scale,
                    float k2, float cap_log2) {
    using L = Bwd<D, false>;
    constexpr int DEPTH = L::DEPTH;
    extern __shared__ __align__(16) uint8_t smem_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    const uint32_t s_base = smem_u32(smem);
    const uint32_t bar = s_base + L::BAR_OFF;
    auto full = [&](int st) { return bar + 8 * (1 + st); };
    auto empty = [&](int st) { return bar + 8 * (1 + DEPTH + st); };
    auto stage = [&](int st) { return s_base + L::RING_OFF
                                      + st * 2 * L::MOV_BYTES; };

    const int n_qt = (S + BQ - 1) / BQ;
    const int bh = gridDim.x / n_qt;                   // B * H
    const int q0 = (n_qt - 1 - (int)(blockIdx.x / bh)) * BQ;
    const int h = (int)(blockIdx.x % bh) % H;
    const int b = (int)(blockIdx.x % bh) / H;
    const int hk = h / (H / Hkv);

    // the key tiles of the block: over the keys its rows see
    int lo, hi;
    rows_band(q0, q0 + BQ, S, T, causal, window, q_offset, lo, hi);
    const int tile_lo = hi > lo ? lo / BK * BK : 0;
    const int n_tiles = hi > lo ? (hi - tile_lo + BK - 1) / BK : 0;

    if (threadIdx.x == 0) {
        mbar_init(bar, 1);
        for (int st = 0; st < DEPTH; ++st) {
            mbar_init(full(st), 1);
            mbar_init(empty(st), 8);       // lane 0 of each consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 0) {
        // ---- producer: one thread ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     :: "n"(PRODUCER_REGS));
        if (threadIdx.x == 0) {
            mbar_expect_tx(bar, 2 * L::FIX_BYTES);
            for (int c = 0; c < D / L::COLS; ++c) {
                tma_load_4d(s_base + L::A_OFF + c * BQ * L::ROW, &tm_q, bar,
                            c * L::COLS, q0, h, b);
                tma_load_4d(s_base + L::B_OFF + c * BQ * L::ROW, &tm_do, bar,
                            c * L::COLS, q0, h, b);
            }
            for (int j = 0; j < n_tiles; ++j) {
                const int st = j % DEPTH, ph = (j / DEPTH) & 1;
                const int t0 = tile_lo + j * BK;
                mbar_wait(empty(st), ph ^ 1);
                mbar_expect_tx(full(st), 2 * L::MOV_BYTES);
                for (int c = 0; c < D / L::COLS; ++c) {
                    tma_load_4d(stage(st) + c * BK * L::ROW, &tm_k, full(st),
                                c * L::COLS, t0, hk, b);
                    tma_load_4d(stage(st) + L::MOV_BYTES + c * BK * L::ROW,
                                &tm_v, full(st), c * L::COLS, t0, hk, b);
                }
            }
        }
    } else {
        // ---- consumers: 64 q rows each ----
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                     :: "n"(CONSUMER_REGS));
        const int w = wg - 1;
        const int tid = threadIdx.x & 127;
        const int warp = tid >> 5, lane = tid & 31;
        const int r0 = q0 + 64 * w;
        const long long qstride = (long long)H * D;
        const long long rows_at = ((long long)b * H + h) * S;
        float* dl_s = reinterpret_cast<float*>(smem + L::ROWS_OFF) + 64 * w;

        {   // delta of the warpgroup's rows, two threads a row, of o + o_lo
            const int r = tid >> 1, half = tid & 1;
            float dl = 0.0f;
            if (r0 + r < S) {
                const long long at = (((long long)b * S + r0 + r) * H + h) * D;
                const uint4* o8 = reinterpret_cast<const uint4*>(o + at)
                                  + half * (D / 16);
                const uint4* l8 = reinterpret_cast<const uint4*>(o_lo + at)
                                  + half * (D / 16);
                const uint4* d8 = reinterpret_cast<const uint4*>(dout + at)
                                  + half * (D / 16);
#pragma unroll
                for (int i = 0; i < D / 16; ++i) {
                    const uint4 a = o8[i], a2 = l8[i], c = d8[i];
                    const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
                    const uint32_t lw[4] = {a2.x, a2.y, a2.z, a2.w};
                    const uint32_t cw[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        dl = fmaf(__uint_as_float(aw[e] << 16)
                                      + __uint_as_float(lw[e] << 16),
                                  __uint_as_float(cw[e] << 16), dl);
                        dl = fmaf(__uint_as_float(aw[e] & 0xffff0000u)
                                      + __uint_as_float(lw[e] & 0xffff0000u),
                                  __uint_as_float(cw[e] & 0xffff0000u), dl);
                    }
                }
            }
            dl += __shfl_xor_sync(0xffffffffu, dl, 1);
            if (half == 0) {
                dl_s[r] = dl;
                if (r0 + r < S) delta[rows_at + r0 + r] = dl;
            }
            asm volatile("bar.sync %0, 128;\n" :: "r"(1 + w) : "memory");
        }

        // this thread's rows: ra (accumulator rows lane/4) and rb (+ 8)
        const int row = 16 * warp + (lane >> 2);
        const int ra = r0 + row, rb = ra + 8;
        int lo_a, hi_a, lo_b, hi_b;
        band(q_offset + ra, T, causal, window, lo_a, hi_a);
        band(q_offset + rb, T, causal, window, lo_b, hi_b);
        if (ra >= S) hi_a = lo_a;                  // padding rows see none
        if (rb >= S) hi_b = lo_b;
        const float lse_a = ra < S ? lse[rows_at + ra] * LOG2E : 0.0f;
        const float lse_b = rb < S ? lse[rows_at + rb] * LOG2E : 0.0f;
        const float dl_a = dl_s[row], dl_b = dl_s[row + 8];
        const float scale_log2 = scale * LOG2E;
        // CAP: P (1 - t^2) = 2^(cap_log2 (1 - 2r) - lse + 2) (r - r^2), r
        // of fa_hopper.cuh's softcap_r, 1 - t^2 = 4 r (1 - r) with its 4
        // in the exponent: one FFMA of a row's constant before the ex2
        const float cap_m2 = -2.0f * cap_log2;
        const float cl_a = cap_log2 - lse_a + 2.0f;
        const float cl_b = cap_log2 - lse_b + 2.0f;
        const int pa = q_offset + r0;              // the first row's place

        // the run [j_a, j_b) of the block's tiles that these rows see
        int j_a = n_tiles, j_b = n_tiles;
        {
            int wlo, whi;
            rows_band(r0, r0 + 64, S, T, causal, window, q_offset, wlo, whi);
            if (whi > wlo) {
                j_a = (wlo - tile_lo) / BK;
                j_b = min(n_tiles, (whi - tile_lo + BK - 1) / BK);
            }
        }

        float acc[D / 2];
        zero(acc);
        const uint32_t s_q = s_base + L::A_OFF + w * 64 * L::ROW;
        const uint32_t s_do = s_base + L::B_OFF + w * 64 * L::ROW;
        mbar_wait(bar, 0);
        for (int j = 0; j < n_tiles; ++j) {
            const int st = j % DEPTH, ph = (j / DEPTH) & 1;
            mbar_wait(full(st), ph);
            if (j >= j_a && j < j_b) {
                const uint32_t s_k = stage(st);
                const uint32_t s_v = s_k + L::MOV_BYTES;
                const int t0 = tile_lo + j * BK;
                float s[32], dp[32];
                wgmma_fence();
                wgmma_abt<D, BQ, BK>(s, s_q, s_k);
                wgmma_commit();
                wgmma_abt<D, BQ, BK>(dp, s_do, s_v);
                wgmma_commit();
                wgmma_wait<1>();
                fence_regs(s);
                // P in S's place; element i: row a or b by (i >> 1) & 1,
                // key t0 + 8 (i / 4) + 2 (lane % 4) + (i & 1); the masks
                // only on a tile that cuts a band edge or holds keys past
                // T or rows past S (an interior tile's every key is seen
                // by every one of the 64 rows).  CAP: every score capped,
                // and P (1 - t^2) in P's place, on every tile by the
                // masked path (an interior path for CAP tiles measured
                // 3-5 % slower: its mask arithmetic hides under the SFU
                // work; tools/k4_bwd_tc_variants.py: cap_interior)
                if (!CAP && t0 + BK <= T && r0 + 64 <= S
                        && (!causal || t0 + BK - 1 <= pa)
                        && (window <= 0 || t0 >= pa + 64 - window)) {
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
                        if constexpr (CAP) {
                            const float r = softcap_r(s[i], k2);
                            s[i] = vis ? ex2(fmaf(cap_m2, r,
                                                  rb_ ? cl_b : cl_a))
                                             * fmaf(-r, r, r)
                                       : 0.0f;
                        } else {
                            s[i] = vis ? ex2(fmaf(s[i], scale_log2,
                                                  -(rb_ ? lse_b : lse_a)))
                                       : 0.0f;
                        }
                    }
                }
                wgmma_wait<0>();
                fence_regs(dp);
#pragma unroll
                for (int i = 0; i < 32; ++i)
                    s[i] *= dp[i] - (((i >> 1) & 1) ? dl_b : dl_a);
                uint32_t ds_hi[4][4], ds_lo[4][4];
                split_frags(s, ds_hi, ds_lo);
                wgmma_fence();
                wgmma_parts<D, BK>(acc, ds_hi, ds_lo, s_k);
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(acc);
            }
            if (lane == 0) mbar_arrive(empty(st));
        }
        store_rows<D>(dq + ((long long)b * S * H + h) * D, acc, scale, r0,
                      S, qstride, warp, lane);
    }
}

// ---- dk, dv --------------------------------------------------------------

// The q tiles of BM rows a key range [k0, k1) visits: rows whose band
// meets it have absolute positions p in [pa, pb) (the bands' ends grow
// with p), and rows that see no key (only under a window: p >= T +
// window - 1) come after them; tiles [ta0, ta0 + na), then [te, n_qt).
struct Walk {
    int ta0, na, te;
    __device__ __forceinline__ int tile(int j) const {
        return j < na ? ta0 + j : te + j - na;
    }
};

__device__ __forceinline__ Walk walk_of(int k0, int k1, int S, int T,
                                        int causal, int window, int q_offset,
                                        int& n_tiles) {
    const int n_qt = (S + BM - 1) / BM;
    const long long pa = causal ? k0 : 0;
    const long long pb = window > 0 ? (long long)k1 + window - 1
                                    : (long long)q_offset + S;
    const long long ra = max(0LL, pa - q_offset);
    const long long rb = min((long long)S, pb - q_offset);
    int ta0 = 0, ta1 = 0;
    if (ra < rb) {
        ta0 = (int)(ra / BM);
        ta1 = (int)((rb - 1) / BM) + 1;
    }
    int te = n_qt;
    if (window > 0) {
        const long long re = max(0LL, (long long)T + window - 1 - q_offset);
        if (re < S) te = max(ta1, (int)(re / BM));
    }
    n_tiles = ta1 - ta0 + n_qt - te;
    return Walk{ta0, ta1 - ta0, te};
}

// CAP: with a logit softcap (k2, cap_log2 read only then)
template <int D, bool CAP>
__global__ void __launch_bounds__(THREADS, 1)
fa_bwd_tc_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
                      int T, int H, int Hkv, int causal, int window,
                      int q_offset, float scale, float k2,
                      float cap_log2) {
    using L = Bwd<D, true>;
    constexpr int DEPTH = L::DEPTH;
    constexpr int NK = kv_keys<D>();
    constexpr bool SPLIT = D >= 128;           // one output a warpgroup
    extern __shared__ __align__(16) uint8_t smem_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    const uint32_t s_base = smem_u32(smem);
    const uint32_t bar = s_base + L::BAR_OFF;
    auto full = [&](int st) { return bar + 8 * (1 + st); };
    auto empty = [&](int st) { return bar + 8 * (1 + DEPTH + st); };
    auto stage = [&](int st) { return s_base + L::RING_OFF
                                      + st * 2 * L::MOV_BYTES; };
    // a stage's lse (scaled by log2 e) and delta rows
    auto rows_of = [&](int st) {
        return reinterpret_cast<float*>(smem + L::ROWS_OFF
                                        + st * L::ROWS_BYTES);
    };

    const int n_kt = (T + NK - 1) / NK;
    const int bh = gridDim.x / n_kt;                   // B * Hkv
    const int k0 = (int)(blockIdx.x / bh) * NK;
    const int hk = (int)(blockIdx.x % bh) % Hkv;
    const int b = (int)(blockIdx.x % bh) / Hkv;
    const int rep = H / Hkv;
    int n_tiles;
    const Walk walk = walk_of(k0, min(T, k0 + NK), S, T, causal, window,
                              q_offset, n_tiles);
    const int n_items = n_tiles * rep;

    if (threadIdx.x == 0) {
        mbar_init(bar, 1);
        for (int st = 0; st < DEPTH; ++st) {
            mbar_init(full(st), 1 + 32);   // the TMA's, and the rows' warp
            mbar_init(empty(st), 8);       // lane 0 of each consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 0) {
        // ---- producer: warp 0 (its lane 0 the TMA loads) ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     :: "n"(PRODUCER_REGS));
        const int lane = threadIdx.x & 31;
        if (threadIdx.x < 32) {
            if (lane == 0) {
                mbar_expect_tx(bar, 2 * L::FIX_BYTES);
                for (int c = 0; c < D / L::COLS; ++c) {
                    tma_load_4d(s_base + L::A_OFF + c * NK * L::ROW, &tm_k,
                                bar, c * L::COLS, k0, hk, b);
                    tma_load_4d(s_base + L::B_OFF + c * NK * L::ROW, &tm_v,
                                bar, c * L::COLS, k0, hk, b);
                }
            }
            for (int i = 0; i < n_items; ++i) {
                const int st = i % DEPTH, ph = (i / DEPTH) & 1;
                const int r0 = walk.tile(i / rep) * BM;
                const int h = hk * rep + i % rep;
                mbar_wait(empty(st), ph ^ 1);
                if (lane == 0) {
                    mbar_expect_tx(full(st), 2 * L::MOV_BYTES);
                    for (int c = 0; c < D / L::COLS; ++c) {
                        tma_load_4d(stage(st) + c * BM * L::ROW, &tm_q,
                                    full(st), c * L::COLS, r0, h, b);
                        tma_load_4d(stage(st) + L::MOV_BYTES
                                        + c * BM * L::ROW,
                                    &tm_do, full(st), c * L::COLS, r0, h, b);
                    }
                }
                float* rows = rows_of(st);
                const long long at = ((long long)b * H + h) * S + r0;
                for (int c = lane; c < BM; c += 32) {
                    const bool ok = r0 + c < S;
                    rows[c] = ok ? lse[at + c] * LOG2E : 0.0f;
                    rows[BM + c] = ok ? delta[at + c] : 0.0f;
                }
                mbar_arrive(full(st));
            }
        }
    } else {
        // ---- consumers: 64 keys each (D >= 128: the same 64) ----
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                     :: "n"(CONSUMER_REGS));
        const int w = wg - 1;
        const int tid = threadIdx.x & 127;
        const int warp = tid >> 5, lane = tid & 31;
        const int kw = SPLIT ? 0 : 64 * w;         // the warpgroup's keys
        const int kw0 = k0 + kw;                   // its first key
        const int key_a = kw0 + 16 * warp + (lane >> 2);
        const int key_b = key_a + 8;
        const float scale_log2 = scale * LOG2E;
        const float cap_m2 = -2.0f * cap_log2;     // CAP: softcap_r's FFMA
        const float inv_t = 1.0f / (float)T;
        const int p_blind = T + window - 1;        // rows from here see none

        float acc[D / 2];                // dk (D >= 128: dv or dk)
        float acc_v[SPLIT ? 2 : D / 2];  // dv
        zero(acc);
        zero(acc_v);
        const uint32_t s_k = s_base + L::A_OFF + kw * L::ROW;
        const uint32_t s_v = s_base + L::B_OFF + kw * L::ROW;
        mbar_wait(bar, 0);
        for (int i = 0; i < n_items; ++i) {
            const int st = i % DEPTH, ph = (i / DEPTH) & 1;
            const int r0 = walk.tile(i / rep) * BM;
            mbar_wait(full(st), ph);
            const uint32_t s_q = stage(st);
            const uint32_t s_do = s_q + L::MOV_BYTES;
            const float* lse_c = rows_of(st);
            const float* dl_c = lse_c + BM;
            float s[32], dp[32];
            wgmma_fence();
            wgmma_abt<D, NK, BM>(s, s_k, s_q);
            wgmma_commit();
            wgmma_abt<D, NK, BM>(dp, s_v, s_do);
            wgmma_commit();
            wgmma_wait<1>();
            fence_regs(s);
            // P^T in S^T's place, under dP^T's product; element e: key a
            // or b by (e >> 1) & 1, q row r0 + 8 (e / 4) + 2 (lane % 4) +
            // (e & 1); the masks only on an item whose rows do not all
            // see every key of the warpgroup (then none of them is a row
            // that sees no key)
            uint32_t blind = 0;     // bit e: its row sees no key
            const int p0 = q_offset + r0;
            // CAP: (1 - t^2) / 4 = r (1 - r) of each element (its 4 in
            // dk's scale; 0 where the row sees no key, so that dS^T = 0),
            // kept from P^T's r, formed under dP^T's product, until dS^T
            float dtanh[CAP ? 32 : 1];
            if (r0 + BM <= S && kw0 + 64 <= T
                    && (!causal || kw0 + 63 <= p0)
                    && (window <= 0 || kw0 > p0 + BM - 1 - window)) {
                // CAP: the capped scores without the masks (their integer
                // work does not hide under the cap's SFU work here, as it
                // does in dq: tools/k4_bwd_tc_variants.py: cap_kv_masked)
#pragma unroll
                for (int e = 0; e < 32; ++e) {
                    const int col = 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
                    if constexpr (CAP) {
                        const float r = softcap_r(s[e], k2);
                        s[e] = ex2(fmaf(cap_m2, r, cap_log2 - lse_c[col]));
                        if (!SPLIT || w) dtanh[e] = fmaf(-r, r, r);
                    } else {
                        s[e] = ex2(fmaf(s[e], scale_log2, -lse_c[col]));
                    }
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
                    if constexpr (CAP) {
                        const float r = softcap_r(s[e], k2);
                        s[e] = none ? (in ? inv_t : 0.0f)
                                    : vis ? ex2(fmaf(cap_m2, r, cap_log2
                                                     - lse_c[col]))
                                          : 0.0f;
                        // D >= 128: warpgroup 1 sums dv from P^T alone
                        if (!SPLIT || w)
                            dtanh[e] = none ? 0.0f : fmaf(-r, r, r);
                    } else {
                        blind |= (uint32_t)(none && row < S) << e;
                        s[e] = none ? (in ? inv_t : 0.0f)
                                    : vis ? ex2(fmaf(s[e], scale_log2,
                                                     -lse_c[col]))
                                          : 0.0f;
                    }
                }
            }
            // dS^T in dP^T's place
            if constexpr (!CAP) {
                wgmma_wait<0>();
                fence_regs(dp);
#pragma unroll
                for (int e = 0; e < 32; ++e) {
                    const int col = 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
                    dp[e] = (blind >> e) & 1u ? 0.0f
                                              : s[e] * (dp[e] - dl_c[col]);
                }
            }
            if constexpr (CAP && SPLIT) {
                // dS^T / 4 = P^T (dP^T - delta) r (1 - r) in P^T's place
                // once dP^T has landed; warpgroup 1 sums dv = P^T.dO and
                // needs none.  The products as without a cap
                wgmma_wait<0>();
                fence_regs(dp);
                if (w) {
#pragma unroll
                    for (int e = 0; e < 32; ++e) {
                        const int col = 8 * (e >> 2) + 2 * (lane & 3)
                                        + (e & 1);
                        s[e] *= (dp[e] - dl_c[col]) * dtanh[e];
                    }
                }
            }
            uint32_t hi[4][4], lo[4][4];
            if constexpr (CAP && !SPLIT) {
                // the second products, A as two bf16 parts: dv += P^T.dO
                // issued as soon as P^T is split; under it dS^T / 4 =
                // P^T (dP^T - delta) r (1 - r) is formed into a second
                // set of parts, then dk += dS^T.Q
                split_frags(s, hi, lo);
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
            } else if constexpr (SPLIT) {
                // the second products, A as two bf16 parts: one at a
                // time, so that the parts of one operand and both sums
                // fit the consumer's registers.  P^T.dO (dv) or dS^T.Q
                // (dk): the same instructions in both warpgroups on
                // selected operands (no divergent path around the
                // products; CAP: s holds each warpgroup's operand)
                if constexpr (!CAP) {
#pragma unroll
                    for (int e = 0; e < 32; ++e) s[e] = w ? dp[e] : s[e];
                }
                split_frags(s, hi, lo);
                wgmma_fence();
                wgmma_parts<D, BM>(acc, hi, lo, w ? s_q : s_do);
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(acc);
            } else {
                split_frags(s, hi, lo);
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
                fence_regs(acc);
            }
            if (lane == 0) mbar_arrive(empty(st));
        }
        const long long stride = (long long)Hkv * D;
        const long long at = ((long long)b * T * Hkv + hk) * D;
        // CAP: dk summed of dS^T / 4 (exact: a power of two)
        const float dk_mul = CAP ? 4.0f * scale : scale;
        if constexpr (SPLIT) {
            store_rows<D>((w == 0 ? dv : dk) + at, acc,
                          w == 0 ? 1.0f : dk_mul, k0, T, stride, warp, lane);
        } else {
            store_rows<D>(dv + at, acc_v, 1.0f, k0 + kw, T, stride, warp,
                          lane);
            store_rows<D>(dk + at, acc, dk_mul, k0 + kw, T, stride, warp,
                          lane);
        }
    }
}

// ---- host side -----------------------------------------------------------

// the (D, rows, heads, batch) map of a contiguous (B, rows, heads, D)
// bf16 tensor, boxes of (COLS, box_rows)
template <int D>
static int map_of(CUtensorMap* map, const void* p, int B, int rows,
                  int heads, int box_rows) {
    const long long row = 2LL * heads * D;
    const MapKey key = {p, {D, rows, heads, B},
                        {row, 2LL * D, row * rows}, Tiles<D>::COLS, box_rows};
    return tensor_map(map, key);
}

// The CAP kernels' second constant, as the bf16 forward's launch
// computes it (flash_attention.cu: tc::launch_as): cap * log2 e (the
// first, fa_hopper.cuh's softcap_k2: 2 log2 e * scale / cap)
static float cap_log2_of(float softcap) {
    return softcap > 0.0f ? (float)((double)softcap * 1.4426950408889634)
                          : 0.0f;
}

// CAP: with a softcap > 0 (flash_attention_bwd_tc_softcap.cu's
// instantiations)
template <int D, bool CAP = false>
static int launch_dq(const void* q, const void* k, const void* v,
                     const void* o, const void* o_lo, const void* dout,
                     const float* lse, float* delta, void* dq, int B, int S,
                     int T, int H, int Hkv, int causal, int window,
                     int q_offset, float scale, cudaStream_t stream,
                     float softcap = 0.0f) {
    // a runtime call first: it makes the device's primary context
    // current on this thread, which cuTensorMapEncodeTiled needs
    // (autograd runs a backward on a thread of its own)
    const int smem = Bwd<D, false>::ALLOC;
    cudaError_t ce = cudaFuncSetAttribute(
        fa_bwd_tc_dq_kernel<D, CAP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (ce != cudaSuccess) return (int)ce;
    CUtensorMap mq, mdo, mk, mv;
    int err = map_of<D>(&mq, q, B, S, H, BQ);
    if (err == 0) err = map_of<D>(&mdo, dout, B, S, H, BQ);
    if (err == 0) err = map_of<D>(&mk, k, B, T, Hkv, BK);
    if (err == 0) err = map_of<D>(&mv, v, B, T, Hkv, BK);
    if (err != 0) return err;
    const long long blocks = (long long)((S + BQ - 1) / BQ) * H * B;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    fa_bwd_tc_dq_kernel<D, CAP><<<(unsigned)blocks, THREADS, smem, stream>>>(
        mq, mdo, mk, mv, static_cast<const bf16*>(o),
        static_cast<const bf16*>(o_lo), static_cast<const bf16*>(dout), lse,
        delta, static_cast<bf16*>(dq), S, T, H, Hkv, causal, window,
        q_offset, scale, softcap_k2(scale, softcap), cap_log2_of(softcap));
    return (int)cudaGetLastError();
}

template <int D, bool CAP = false>
static int launch_dkdv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int S,
                       int T, int H, int Hkv, int causal, int window,
                       int q_offset, float scale, cudaStream_t stream,
                       float softcap = 0.0f) {
    const int smem = Bwd<D, true>::ALLOC;      // a runtime call first
    cudaError_t ce = cudaFuncSetAttribute(
        fa_bwd_tc_dkdv_kernel<D, CAP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (ce != cudaSuccess) return (int)ce;
    CUtensorMap mq, mdo, mk, mv;
    int err = map_of<D>(&mq, q, B, S, H, BM);
    if (err == 0) err = map_of<D>(&mdo, dout, B, S, H, BM);
    if (err == 0) err = map_of<D>(&mk, k, B, T, Hkv, kv_keys<D>());
    if (err == 0) err = map_of<D>(&mv, v, B, T, Hkv, kv_keys<D>());
    if (err != 0) return err;
    const long long blocks =
        (long long)((T + kv_keys<D>() - 1) / kv_keys<D>()) * Hkv * B;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    fa_bwd_tc_dkdv_kernel<D, CAP><<<(unsigned)blocks, THREADS, smem,
                                    stream>>>(
        mq, mdo, mk, mv, lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), S, T, H, Hkv, causal, window, q_offset,
        scale, softcap_k2(scale, softcap), cap_log2_of(softcap));
    return (int)cudaGetLastError();
}

}  // namespace tc

// The kernels end here: flash_attention_bwd_tc_softcap.cu includes this
// file with FB_TC_KERNELS_ONLY defined, for the CAP instantiations alone.
#ifndef FB_TC_KERNELS_ONLY

// The bf16 pair with a logit softcap > 0: defined in
// flash_attention_bwd_tc_softcap.cu, linked into this library; the
// arguments of tc::launch_dq / tc::launch_dkdv, then D
int fb_tc_dq_softcap(const void* q, const void* k, const void* v,
                     const void* o, const void* o_lo, const void* dout,
                     const float* lse, float* delta, void* dq, int B, int S,
                     int T, int H, int Hkv, int causal, int window,
                     int q_offset, float scale, cudaStream_t stream,
                     float softcap, int D);
int fb_tc_dkdv_softcap(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int S,
                       int T, int H, int Hkv, int causal, int window,
                       int q_offset, float scale, cudaStream_t stream,
                       float softcap, int D);

namespace tc {

static bool shape_ok(int B, int S, int T, int H, int Hkv, int q_offset) {
    return B >= 1 && S >= 1 && T >= 1 && H >= 1 && Hkv >= 1 && H % Hkv == 0
           && q_offset >= 0;
}

static bool aligned(const void* p) {
    return p != nullptr && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 0, or a finite cap > 0 on the scores (the forward's, whose lse it is)
static bool softcap_ok(float softcap) {
    return softcap >= 0.0f && !isinf(softcap);
}

}  // namespace tc

// The entries of the bf16 pair, with flash_attention_bwd.cu's argument
// lists.  q, o, o_lo, dout, dq (B,S,H,D) and k, v, dk, dv (B,T,Hkv,D)
// bf16, contiguous, on 16-byte addresses (TMA); lse and delta (B,H,S)
// f32 contiguous; D in {16, 32, 64, 80, 128, 192}.  dq writes dq and
// delta = rowsum(dout * (o + o_lo)); dkdv reads that delta (so it is
// launched after dq on the same stream) and writes dk and dv, each
// summed over the kv head's group of q heads.  Each returns
// cudaGetLastError() after its launch (or the error that kept it from
// launching: cudaErrorInvalidValue for a shape, D or address it does
// not take); neither synchronises.  softcap: 0, or the forward's cap >
// 0, which takes the CAP instantiations of
// flash_attention_bwd_tc_softcap.cu.
extern "C" int flash_attention_bwd_dq_bf16(
        const void* q, const void* k, const void* v, const void* o,
        const void* o_lo, const void* dout, const void* lse, void* delta,
        void* dq, int B, int S, int T_len, int H, int Hkv, int D,
        int causal, int window, int q_offset, float scale, void* stream,
        float softcap) {
    using namespace tc;
    if (!shape_ok(B, S, T_len, H, Hkv, q_offset) || !aligned(q)
            || !aligned(k) || !aligned(v) || !aligned(o) || !aligned(o_lo)
            || !aligned(dout) || !aligned(dq) || !softcap_ok(softcap))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TC_DQ_ARGS q, k, v, o, o_lo, dout, static_cast<const float*>(lse), \
    static_cast<float*>(delta), dq, B, S, T_len, H, Hkv, causal, window, \
    q_offset, scale, s
    if (softcap > 0.0f) return fb_tc_dq_softcap(TC_DQ_ARGS, softcap, D);
    switch (D) {
        case 16: return launch_dq<16>(TC_DQ_ARGS);
        case 32: return launch_dq<32>(TC_DQ_ARGS);
        case 64: return launch_dq<64>(TC_DQ_ARGS);
        case 80: return launch_dq<80>(TC_DQ_ARGS);
        case 128: return launch_dq<128>(TC_DQ_ARGS);
        case 192: return launch_dq<192>(TC_DQ_ARGS);
    }
#undef TC_DQ_ARGS
    return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd_dkdv_bf16(
        const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv, int B,
        int S, int T_len, int H, int Hkv, int D, int causal, int window,
        int q_offset, float scale, void* stream, float softcap) {
    using namespace tc;
    if (!shape_ok(B, S, T_len, H, Hkv, q_offset) || !aligned(q)
            || !aligned(k) || !aligned(v) || !aligned(dout) || !aligned(dk)
            || !aligned(dv) || !softcap_ok(softcap))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TC_KV_ARGS q, k, v, dout, static_cast<const float*>(lse), \
    static_cast<const float*>(delta), dk, dv, B, S, T_len, H, Hkv, causal, \
    window, q_offset, scale, s
    if (softcap > 0.0f) return fb_tc_dkdv_softcap(TC_KV_ARGS, softcap, D);
    switch (D) {
        case 16: return launch_dkdv<16>(TC_KV_ARGS);
        case 32: return launch_dkdv<32>(TC_KV_ARGS);
        case 64: return launch_dkdv<64>(TC_KV_ARGS);
        case 80: return launch_dkdv<80>(TC_KV_ARGS);
        case 128: return launch_dkdv<128>(TC_KV_ARGS);
        case 192: return launch_dkdv<192>(TC_KV_ARGS);
    }
#undef TC_KV_ARGS
    return (int)cudaErrorInvalidValue;
}

template <int D>
static long long tc_sizes(bool dkdv, int which) {
    using namespace tc;
    switch (which) {
        case 0: return THREADS / 32;
        case 1: return dkdv ? Bwd<D, true>::ALLOC : Bwd<D, false>::ALLOC;
        case 2: return dkdv ? BM : BK;
        case 3: return dkdv ? Bwd<D, true>::DEPTH : Bwd<D, false>::DEPTH;
        case 4: return 1;
        case 5: return dkdv ? (D >= 128 ? 8 : 6) : 4;
        default: return -1;
    }
}

// The launch of one kernel at head dim D (kernel 0: dq, 1: dkdv):
// which = 0, warps a block; 1, bytes of dynamic shared memory; 2, rows
// of a moving tile (keys in dq, q rows in dkdv); 3, stages of its ring;
// 4, the grid's y; 5, the D-long dots it computes a visible (q, k) pair.
// -1 for a D, kernel or which it does not have.
extern "C" long long flash_attention_bwd_tc_sizes(int D, int kernel,
                                                  int which) {
    if (kernel != 0 && kernel != 1) return -1;
    switch (D) {
        case 16: return tc_sizes<16>(kernel == 1, which);
        case 32: return tc_sizes<32>(kernel == 1, which);
        case 64: return tc_sizes<64>(kernel == 1, which);
        case 80: return tc_sizes<80>(kernel == 1, which);
        case 128: return tc_sizes<128>(kernel == 1, which);
        case 192: return tc_sizes<192>(kernel == 1, which);
    }
    return -1;
}

#endif  // FB_TC_KERNELS_ONLY
