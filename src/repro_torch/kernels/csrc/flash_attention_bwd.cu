// The f32 backward of K4, the GQA online-softmax attention of
// flash_attention.cu, for Hopper (sm_90a): two kernels whose products
// run on the tensor cores in split TF32.
//
// The JAX package has no backward Pallas kernel: JAX differentiates the
// jnp attention and its training never calls src/repro/kernels/
// flash_attention.py: _kernel.  The port routes every CUDA tensor to its
// forward kernel, so a gradient through that kernel needs these.  The
// bf16 backward is flash_attention_bwd_tc.cu's (wgmma fed by TMA).
//
//   q, o, dO (B,S,H,D), k, v (B,T,Hkv,D), all contiguous f32 on 16-byte
//   addresses; lse (B,H,S) f32 from the forward (m + log(max(l, 1e-30))
//   of each row).  Query head h reads kv head h / (H/Hkv), as in the
//   forward.
//
//   s_ij   = (q_i . k_j) * scale, visible by the forward's masks
//   P_ij   = exp(s_ij - lse_i) if visible, else 0
//   delta_i = sum_d dO_id * o_id
//   dS_ij  = P_ij * (dO_i . v_j - delta_i)
//   dq_i   = scale * sum_j dS_ij k_j
//   dk_j   = scale * sum_{h in group} sum_i dS_ij q_i
//   dv_j   = sum_{h in group} sum_i P_ij dO_i
//
// With a logit softcap (the CAP instantiations, built in
// flash_attention_bwd_softcap.cu, which includes this file with
// FB_KERNELS_ONLY and is linked into its library), the score is capped
// as the forward capped it, with the same tanhf (flash_attention.cu:
// fa_softcap), so P is of the capped score and matches the lse the
// forward wrote, and dS takes the cap's derivative:
//
//   t_ij   = tanh(s_ij / cap),  c_ij = cap * t_ij
//   P_ij   = exp(c_ij - lse_i) if visible, else 0
//   dS_ij  = P_ij * (dO_i . v_j - delta_i) * (1 - t_ij^2)
//
// dq forms P * (1 - t^2) in P's place (it needs no P alone); dkdv needs
// P for dv, so its dS recomputes t from P: c = lse + log(P), one more
// special-function operation a pair and no register array more (dkdv
// holds 246 registers at D = 64); a P of 0 (masked, or an exp that
// underflowed) gives dS = 0.
//
// A row that sees no key is, in the forward, the mean of v over all T
// keys (the reference's exp(-1e30 - (-1e30)) = 1 for every key).  Its
// gradient is what autograd of the plain version gives through the
// select that masks the scores: P_ij = 1/T for every key, so dv_j +=
// dO_i / T over all T keys, and dS_ij = 0 (no gradient reaches q or k).
//
// Two launches, no float atomics, so a gradient is the same bits every
// run:
//   flash_attention_bwd_dq_f32: one block per (q tile of 64 rows, q
//     head, b), the last q tiles first (under a causal mask they see
//     the most keys).  It computes delta for its rows and writes it to a
//     (B,H,S) buffer, then walks the key tiles its rows can see,
//     recomputes P from lse, and writes dq once.  Launched first.
//   flash_attention_bwd_dkdv_f32: one block per (key tile of 64 keys,
//     kv head, b), the first key tiles first.  It walks the (q tile of
//     64 rows, 48 at D = 128, 32 at 192; q head of the group) items whose
//     rows see a key of the tile (or hold a row that sees none), in a
//     fixed order, reads delta from the first kernel, and sums dk and dv
//     over them in registers: written once.
//
// Products.  Every product is mma.sync.m16n8k8 in TF32 with f32
// accumulators, each f32 operand x split into a TF32 hi and the rest lo,
// both rounded to nearest (tf32_split.cuh: the forward's split, so S is
// recomputed as the forward formed it against its lse), and a . b taken
// as lo.hi + hi.lo + hi.hi (lo.lo dropped): about 2^-21 relative a
// product at worst, where one TF32 product (about 2^-10) fails the 1e-4
// checks.  S and dP (prod_abt) take each k-step's three products summed
// from zero and added in f32, above D = 64 the odd k-steps in a second
// sum (tf32_mma.cuh: score_step, score_fold, as the forward's S); every
// other tile product is summed from zero and then added to the running
// sum (add_acc).  Up to D
// = 64, four warps a block, each owning 16 rows of the stationary tile
// (q rows in dq, keys in dkdv).  S = Q.K^T (dq) and S^T = K.Q^T (dkdv)
// and the dO.V^T / V.dO^T products take both operands from shared memory
// by ldmatrix (an 8 x 4 block of f32 is an 8 x 8 block of b16).  Their
// accumulators become P and dS in place (mask, expf and the dS formula
// on the fragments) and are then the A operand of the second products
// (dS.K in dq; P^T.dO and dS^T.Q in dkdv) without a trip through shared
// memory (above D = 64, through the pair's exchange, in the same
// layout): the C fragment holds columns 2t and 2t+1 of an 8-wide slice
// where the A fragment wants t and t+4, so the contraction index of that
// slice is permuted (slot t <-> 2t, slot t+4 <-> 2t+1) in A and B alike,
// and B is read as two scalar words a fragment.
//
// Loads.  The moving tiles (K and V in dq; q, dO and their lse and
// delta rows in dkdv) go through a 2-stage ring of 16-byte cp.async
// copies (4-byte for lse and delta), the next tile loading under this
// tile's products; rows past S or T are zero-filled by the copy.  Tile
// rows are padded to D+4 floats, so both the ldmatrix rows and the
// scalar B words are free of bank conflicts.  At D = 64, 104 KB of
// shared memory a block (two blocks an SM).
//
// D = 80, 128 and 192: eight warps a block, and S and dP once a visible
// pair (at D = 80 the four-warp kernels' accumulators would not fit:
// dkdv holds 246 registers at D = 64).  The block keeps its 64 stationary rows; the two warps of a pair
// (w and w + 4) share 16 of them.  Each computes S and dP for its half
// of the moving tile's columns, forms P and dS on its fragments, and
// puts them in the pair's exchange in shared memory (a float4 a lane
// and 8-column slice, so a lane reads back the same fragment slots of
// the other half); after a barrier of the pair's 64 threads (bar.sync
// 1 + pair, 64) each warp runs the second products with the whole
// 16-row P or dS as the A operand over its half of the output columns,
// D/2 = 40, 64 or 96 (20, 32 or 48 accumulator registers an output).  One block
// an SM, eight warps; no grid y.  Moving tiles of 64 rows, or as many
// as two stages fit (48, 32); bytes of dynamic shared memory:
//
//   dq   D = 80: Q, dO 2*64*84*4 = 43,008; ring 2*2*64*84*4 = 86,016;
//        exchange 16,384; in all 145,408
//   dkdv D = 80: K, V 43,008; ring 2*(2*64*84 + 128)*4 = 87,040;
//        exchange 2*4*64*16*4 = 32,768; 162,816
//   dq   D = 128: Q, dO 2*64*132*4 = 67,584; ring 2 stages x (K, V) of
//        64 keys 2*2*64*132*4 = 135,168; dS exchange 4 pairs x 64 x 16
//        floats = 16,384; in all 219,136 (of 232,448)
//   dq   D = 192: Q, dO 2*64*196*4 = 100,352; ring of 32-key tiles
//        2*2*32*196*4 = 100,352; exchange 4*32*16*4 = 8,192; 208,896
//   dkdv D = 128: K, V 67,584; ring 2 x (q, dO of 48 rows, lse, delta)
//        2*(2*48*132 + 96)*4 = 102,144; P and dS exchange 2*4*48*16*4 =
//        24,576; 194,304 (64-row items would need 236,544)
//   dkdv D = 192: K, V 100,352; ring 2*(2*32*196 + 64)*4 = 100,864;
//        exchange 16,384; 217,600
//
// flash_attention_bwd_sizes reports these launches.  No spills.
//
// Bound: per visible (q, k) pair of a head, 10*D f32 flops (five dots
// of D) and one exp; in split TF32 each flop is three on the tensor
// cores (494.7e12 TF32 flop/s), against 67e12 f32 flop/s on the CUDA
// cores; the bytes (q, k, v, o, dO read, dq, dk, dv written) are far
// below.  This design computes S and dP in both kernels, 14*D a pair
// (dq three dots, dkdv four) at every D.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fa_exchange.cuh"   // fx_pair_sync, fx_put, fx_get
#include "tf32_split.cuh"    // tf32_split: the forward's split
#include "tf32_mma.cuh"      // mma3, score_step: the forward's products

#define FB_BQ 64
#define FB_BK 64
#define FB_WARPS 4
#define FB_THREADS (32 * FB_WARPS)

// The keys absolute position p sees: [lo, hi) (empty when hi <= lo).
__device__ __forceinline__ void fb_band(int p, int T_len, int causal,
                                        int window, int& lo, int& hi) {
    lo = window > 0 ? max(0, p - window + 1) : 0;
    hi = causal ? min(T_len, p + 1) : T_len;
}

// floats of one 64-row tile padded to D+4
template <int D>
__host__ __device__ constexpr int fb_tile() { return 64 * (D + 4); }

// threads a block: four warps up to D = 64, eight (four pairs) above
template <int D>
__host__ __device__ constexpr int fb_threads() {
    return D <= 64 ? FB_THREADS : 2 * FB_THREADS;
}

// rows of a moving tile (keys in dq, q rows in dkdv): 64, or as many as
// two stages fit beside the exchange -- dkdv 48 at D = 128 (1.059 ms
// against 1.110 with 32 at phi4-mini's layer on an H100 80GB HBM3 at
// 700 W: tools/k4_bwd_variants.py), 32 at D = 192 in both kernels; 64
// at D = 80, where two stages of 64 rows fit in both
template <int D, bool DKDV>
__host__ __device__ constexpr int fb_mrows() {
    return D <= 80 ? 64 : D == 128 ? (DKDV ? 48 : 64) : 32;
}

// stages of the moving tiles' ring
#define FB_STAGES 2

// k-steps of 16 that prod_abt unrolls above D = 64 (4 spilled beside
// score_step's second sum)
#define FB_WIDE_UNROLL 2

// floats of the pair exchanges above D = 64: 4 pairs x (dS; or P and
// dS) x the moving tile's 8-column slices x 32 lanes x a float4
template <int D, bool DKDV>
__host__ __device__ constexpr int fb_exchange_floats() {
    return D <= 64 ? 0 : 4 * (DKDV ? 2 : 1) * fb_mrows<D, DKDV>() * 16;
}

template <int D>
__host__ __device__ constexpr int fb_dq_smem_floats() {
    // Q, dO; stages x (K, V); the exchange
    return 2 * fb_tile<D>()
           + FB_STAGES * 2 * fb_mrows<D, false>() * (D + 4)
           + fb_exchange_floats<D, false>();
}

// K, V; stages x (q, dO, lse, delta); the exchange
template <int D>
__host__ __device__ constexpr int fb_dkdv_smem_floats() {
    constexpr int M = fb_mrows<D, true>();
    return 2 * fb_tile<D>() + FB_STAGES * (2 * M * (D + 4) + 2 * M)
           + fb_exchange_floats<D, true>();
}

// ---- PTX -----------------------------------------------------------------

__device__ __forceinline__ uint32_t fb_smem(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, or 16 zero bytes when !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8 x 4 f32 blocks: lane l gives the row address of block l / 8,
// row l % 8; thread (g = lane/4, t = lane%4) gets element (g, t) of each
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr) : "memory");
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&a)[N][4]) {
#pragma unroll
    for (int n = 0; n < N; ++n) a[n][0] = a[n][1] = a[n][2] = a[n][3] = 0.0f;
}

// a += b, rounded to nearest: a tile's product is summed on the tensor
// cores from zero and only then added to the running sum, whose f32
// adds the tensor cores would round toward zero (a drift that grows
// with the number of tiles: up to 1e-4 relative over llama's 128 (q
// tile, head) pairs a key tile when the running sum was the
// accumulator)
template <int N>
__device__ __forceinline__ void add_acc(float (&a)[N][4],
                                        const float (&b)[N][4]) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
        a[n][0] += b[n][0];
        a[n][1] += b[n][1];
        a[n][2] += b[n][2];
        a[n][3] += b[n][3];
    }
}

// ---- the two kinds of product --------------------------------------------

// acc[n] += A . B^T for the warp's 16 rows of A (at a_row, shared) and
// 8N rows of B (at b_tile, shared), both D wide with stride D+4: acc is
// 16 x 8N, n-th 8-column slice in acc[n]; each k-step's products summed
// from zero, the odd k-steps apart above D = 64 (tf32_mma.cuh:
// score_step, score_fold: the forward's S as it formed it); U k-steps
// of 16 unrolled (one up to D = 64: a k-step's sums from zero hold 8N
// partial sums, and two k-steps' spilled the narrow kernels' registers).
template <int D, int N = 8, int U = 1>
__device__ __forceinline__ void prod_abt(float (&acc)[N][4], uint32_t a_row,
                                         uint32_t b_tile, int lane) {
    constexpr int RS = D + 4;
    const int blk = lane >> 3, r8 = lane & 7;
    const uint32_t a_lane =
        a_row + ((r8 + 8 * (blk & 1)) * RS + 4 * (blk >> 1)) * 4;
    const uint32_t b_lane = b_tile + (r8 * RS + 4 * blk) * 4;
    float odd[N][4];
    zero_acc(odd);
#pragma unroll (U)
    for (int k0 = 0; k0 < D; k0 += 16) {
        uint32_t a0[4], a1[4], a0h[4], a0l[4], a1h[4], a1l[4];
        ldsm_x4(a0, a_lane + k0 * 4);
        ldsm_x4(a1, a_lane + (k0 + 8) * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            tf32_split(__uint_as_float(a0[i]), a0h[i], a0l[i]);
            tf32_split(__uint_as_float(a1[i]), a1h[i], a1l[i]);
        }
#pragma unroll
        for (int n = 0; n < N; ++n) {
            // k-step k0 in words 0-1, k0 + 8 in words 2-3
            uint32_t b[4], bh[4], bl[4];
            ldsm_x4(b, b_lane + (8 * n * RS + k0) * 4);
#pragma unroll
            for (int i = 0; i < 4; ++i)
                tf32_split(__uint_as_float(b[i]), bh[i], bl[i]);
            score_step<D>(acc[n], odd[n], a0h, a0l, a1h, a1l, bh, bl);
        }
    }
    score_fold<D>(acc, odd);
}

// out[n] += C . B: C a 16 x 8KS tile of P or dS in the C-fragment layout
// prod_abt leaves (slice kk in c[kk]), B 8KS rows x NS*8 columns in
// shared memory (stride D+4; all D by default, or NS*8 columns from
// b_tile on); the contraction over C's columns, permuted within each
// 8-wide slice.
template <int D, int NS = D / 8, int KS = 8>
__device__ __forceinline__ void prod_cb(float (&out)[NS][4],
                                        const float (&c)[KS][4],
                                        const float* b_tile, int g, int t) {
    constexpr int RS = D + 4;
    // two slices at a time at D = 192 (all of them spilled a register
    // of the wide dkdv kernel, with its dk and dv sums of 96 columns)
#pragma unroll (D == 192 ? 2 : KS)
    for (int kk = 0; kk < KS; ++kk) {
        uint32_t ah[4], al[4];
        tf32_split(c[kk][0], ah[0], al[0]);     // (g,   slot t)   = col 2t
        tf32_split(c[kk][2], ah[1], al[1]);     // (g+8, slot t)
        tf32_split(c[kk][1], ah[2], al[2]);     // (g,   slot t+4) = col 2t+1
        tf32_split(c[kk][3], ah[3], al[3]);     // (g+8, slot t+4)
        const float* bp = b_tile + (8 * kk + 2 * t) * RS + g;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
            uint32_t bh0, bl0, bh1, bl1;
            tf32_split(bp[8 * n], bh0, bl0);
            tf32_split(bp[RS + 8 * n], bh1, bl1);
            mma3(out[n], ah, al, bh0, bh1, bl0, bl1);
        }
    }
}

// ROWS rows of D floats from global rows (row stride `stride` floats,
// zero-filled from row `n_ok` on) into a padded shared tile, by NT
// threads
template <int D, int ROWS = 64, int NT = FB_THREADS>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long stride, int n_ok,
                                           int tid) {
    constexpr int C4 = D / 4;
#pragma unroll 4
    for (int i = tid; i < ROWS * C4; i += NT) {
        const int r = i / C4, c4 = i % C4;
        const bool ok = r < n_ok;
        cp_async16(fb_smem(dst + r * (D + 4) + 4 * c4),
                   src + (ok ? r * stride + 4 * c4 : 0), ok);
    }
}

// ---- P and dS on the fragments -------------------------------------------

// The forward's cap of a scaled score (flash_attention.cu: fa_softcap):
// t = tanh(s / cap) into th, cap * t returned
__device__ __forceinline__ float fb_cap(float s, float cap, float& th) {
    th = tanhf(s / cap);
    return th * cap;
}

// dq: S of the warp's rows (fragment rows g: band [lo_a, hi_a), lse_a;
// g + 8: the _b ones) against 8N keys from key0, into P in place; CAP:
// the score capped, and P * (1 - t^2) in P's place
template <int N, bool CAP = false>
__device__ __forceinline__ void fb_p_rows(float (&sc)[N][4], int key0, int t,
                                          int lo_a, int hi_a, int lo_b,
                                          int hi_b, float lse_a, float lse_b,
                                          float scale, float cap = 0.0f) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int key = key0 + 8 * n + 2 * t + (e & 1);
            const bool vis = e < 2 ? key >= lo_a && key < hi_a
                                   : key >= lo_b && key < hi_b;
            if constexpr (CAP) {
                float th;
                const float c = fb_cap(sc[n][e] * scale, cap, th);
                sc[n][e] = vis ? expf(c - (e < 2 ? lse_a : lse_b))
                                     * (1.0f - th * th)
                               : 0.0f;
            } else {
                sc[n][e] = vis ? expf(sc[n][e] * scale -
                                      (e < 2 ? lse_a : lse_b))
                               : 0.0f;
            }
        }
    }
}

// dq: dS = P * (dP - delta), in P's place
template <int N>
__device__ __forceinline__ void fb_ds_rows(float (&sc)[N][4],
                                           const float (&dp)[N][4],
                                           float dl_a, float dl_b) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
            sc[n][e] *= dp[n][e] - (e < 2 ? dl_a : dl_b);
    }
}

// dkdv: S^T of the warp's keys (fragment rows g: ka, g + 8: kb) against
// 8N q rows from row0 (their lse from lse_c), into P in place (CAP: of
// the capped score); a row that sees no key gives 1/T to every key.
// Returns bit 2n+c set where column 8n+2t+c is such a row.
template <int N, bool CAP = false>
__device__ __forceinline__ uint32_t fb_p_cols(float (&sc)[N][4], int row0,
                                              const float* lse_c, int ka,
                                              int kb, int t, int S,
                                              int T_len, int causal,
                                              int window, int q_offset,
                                              float scale, float inv_t,
                                              float cap = 0.0f) {
    uint32_t empty = 0;
#pragma unroll
    for (int n = 0; n < N; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const int col = 8 * n + 2 * t + c;
            const int row = row0 + col;
            int lo, hi;
            fb_band(q_offset + row, T_len, causal, window, lo, hi);
            const bool in = row < S;
            const bool none = in && hi <= lo;
            empty |= (uint32_t)none << (2 * n + c);
            const float l = lse_c[col];
#pragma unroll
            for (int e = c; e < 4; e += 2) {
                const int key = e < 2 ? ka : kb;
                float p = 0.0f;
                if (key < T_len) {
                    if (none)
                        p = inv_t;
                    else if (in && key >= lo && key < hi) {
                        if constexpr (CAP) {
                            float th;
                            p = expf(fb_cap(sc[n][e] * scale, cap, th) - l);
                        } else {
                            p = expf(sc[n][e] * scale - l);
                        }
                    }
                }
                sc[n][e] = p;
            }
        }
    }
    return empty;
}

// dkdv: dS^T = P^T * (dP^T - delta) in dP's place (delta of the columns
// from dl_c), 0 in a column that sees no key.  CAP: times 1 - t^2, t
// recomputed from P and the column's lse (lse_c): c = lse + log(P), t =
// c / cap; 0 where P is 0
template <int N, bool CAP = false>
__device__ __forceinline__ void fb_ds_cols(float (&dp)[N][4],
                                           const float (&sc)[N][4],
                                           const float* dl_c, uint32_t empty,
                                           int t, const float* lse_c = nullptr,
                                           float cap = 0.0f) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int c = e & 1;
            const float dl = dl_c[8 * n + 2 * t + c];
            if constexpr (CAP) {
                const float p = sc[n][e];
                const float th = (lse_c[8 * n + 2 * t + c] + logf(p)) / cap;
                dp[n][e] = (empty >> (2 * n + c)) & 1u || !(p > 0.0f)
                    ? 0.0f : p * (dp[n][e] - dl) * (1.0f - th * th);
            } else {
                dp[n][e] = (empty >> (2 * n + c)) & 1u
                    ? 0.0f : sc[n][e] * (dp[n][e] - dl);
            }
        }
    }
}

// ---- dq ------------------------------------------------------------------

#define FB_DQ_PARAMS const float* __restrict__ q, \
    const float* __restrict__ k, const float* __restrict__ v, \
    const float* __restrict__ o, const float* __restrict__ dout, \
    const float* __restrict__ lse, float* __restrict__ delta, \
    float* __restrict__ dq, int S, int T_len, int H, int Hkv, int causal, \
    int window, int q_offset, float scale, float cap
#define FB_DQ_PASS q, k, v, o, dout, lse, delta, dq, S, T_len, H, Hkv, \
    causal, window, q_offset, scale, cap

// delta of the block's 64 rows (two threads a row, fixed order) into
// dl_s and the (B,H,S) buffer; threads 0-127
template <int D>
__device__ __forceinline__ void fb_delta_rows(const float* o,
                                              const float* dout,
                                              float* delta, float* dl_s,
                                              long long qbase,
                                              long long qstride,
                                              long long rbase, int q0, int S,
                                              int tid) {
    const int r = tid >> 1, half = tid & 1;
    float dl = 0.0f;
    if (q0 + r < S) {
        const float4* o4 = reinterpret_cast<const float4*>(
            o + qbase + r * qstride) + half * (D / 8);
        const float4* d4 = reinterpret_cast<const float4*>(
            dout + qbase + r * qstride) + half * (D / 8);
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
            const float4 a = o4[i], c = d4[i];
            dl = fmaf(a.x, c.x, dl);
            dl = fmaf(a.y, c.y, dl);
            dl = fmaf(a.z, c.z, dl);
            dl = fmaf(a.w, c.w, dl);
        }
    }
    dl += __shfl_xor_sync(0xffffffffu, dl, 1);
    if (half == 0) {
        dl_s[r] = dl;
        if (q0 + r < S) delta[rbase + q0 + r] = dl;
    }
}

// the keys the block's 64 rows see, [lo, hi) over the rows that see any
__device__ __forceinline__ void fb_key_range(int q0, int S, int T_len,
                                             int causal, int window,
                                             int q_offset, int& lo_out,
                                             int& hi_out) {
    int l0 = T_len, h0 = 0;
    for (int rr = 0; rr < FB_BQ && q0 + rr < S; ++rr) {
        int l, u;
        fb_band(q_offset + q0 + rr, T_len, causal, window, l, u);
        if (u > l) {
            l0 = min(l0, l);
            h0 = max(h0, u);
        }
    }
    lo_out = l0;
    hi_out = h0;
}

// D <= 64: four warps, each 16 q rows against the whole 64-key tile.
// CAP: the scores capped (fb_p_rows)
template <int D, bool CAP>
__device__ __forceinline__ void fb_dq_narrow(FB_DQ_PARAMS) {
    constexpr int RS = D + 4;
    constexpr int TILE = fb_tile<D>();
    extern __shared__ float4 fb_smem4[];
    float* Qs = reinterpret_cast<float*>(fb_smem4);   // [64][RS]
    float* DOs = Qs + TILE;                            // [64][RS]
    float* ring = DOs + TILE;                          // stages x (K, V)
    __shared__ float dl_s[FB_BQ];
    __shared__ int range_lo, range_hi;

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int n_qt = (S + FB_BQ - 1) / FB_BQ;
    const int bh = gridDim.x / n_qt;                   // B * H
    const int qt = n_qt - 1 - (int)(blockIdx.x / bh);
    const int h = (int)(blockIdx.x % bh) % H;
    const int b = (int)(blockIdx.x % bh) / H;
    const int hk = h / (H / Hkv);
    const int q0 = qt * FB_BQ;
    const long long qstride = (long long)H * D;
    const long long qbase = (((long long)b * S + q0) * H + h) * D;

    stage_rows<D>(Qs, q + qbase, qstride, S - q0, tid);
    stage_rows<D>(DOs, dout + qbase, qstride, S - q0, tid);
    cp_async_commit();
    const long long rsa = ((long long)b * H + h) * S;
    fb_delta_rows<D>(o, dout, delta, dl_s, qbase, qstride, rsa, q0, S, tid);
    if (tid == 0)
        fb_key_range(q0, S, T_len, causal, window, q_offset, range_lo,
                     range_hi);
    __syncthreads();

    // this thread's two rows: ra (fragment rows g) and rb (g + 8)
    const int ra = q0 + 16 * warp + g, rb = ra + 8;
    int lo_a, hi_a, lo_b, hi_b;
    fb_band(q_offset + ra, T_len, causal, window, lo_a, hi_a);
    fb_band(q_offset + rb, T_len, causal, window, lo_b, hi_b);
    if (ra >= S) hi_a = lo_a;                // no key for a padding row
    if (rb >= S) hi_b = lo_b;
    const float lse_a = ra < S ? lse[rsa + ra] : 0.0f;
    const float lse_b = rb < S ? lse[rsa + rb] : 0.0f;
    const float dl_a = dl_s[16 * warp + g], dl_b = dl_s[16 * warp + g + 8];

    const int t_start = (range_lo / FB_BK) * FB_BK;
    const int n_kt = range_hi > t_start
        ? (range_hi - t_start + FB_BK - 1) / FB_BK : 0;
    const long long kvstride = (long long)Hkv * D;
    const long long kvbase = ((long long)b * T_len * Hkv + hk) * D;
    auto load_kv = [&](int i) {
        const int t0 = t_start + FB_BK * i;
        float* Kst = ring + (i % FB_STAGES) * 2 * TILE;
        stage_rows<D>(Kst, k + kvbase + t0 * kvstride, kvstride, T_len - t0,
                      tid);
        stage_rows<D>(Kst + TILE, v + kvbase + t0 * kvstride, kvstride,
                      T_len - t0, tid);
    };
    if (n_kt > 0) load_kv(0);
    cp_async_commit();

    float dqa[D / 8][4];
    zero_acc(dqa);
    const uint32_t q_row = fb_smem(Qs + 16 * warp * RS);
    const uint32_t do_row = fb_smem(DOs + 16 * warp * RS);

    for (int i = 0; i < n_kt; ++i) {
        if (i + 1 < n_kt) load_kv(i + 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const float* Kst = ring + (i % FB_STAGES) * 2 * TILE;
        const float* Vst = Kst + TILE;
        const int t0 = t_start + FB_BK * i;

        float sc[8][4];
        zero_acc(sc);
        prod_abt<D>(sc, q_row, fb_smem(Kst), lane);
        fb_p_rows<8, CAP>(sc, t0, t, lo_a, hi_a, lo_b, hi_b, lse_a, lse_b,
                          scale, cap);
        float dp[8][4];
        zero_acc(dp);
        prod_abt<D>(dp, do_row, fb_smem(Vst), lane);
        fb_ds_rows<8>(sc, dp, dl_a, dl_b);
        float part[D / 8][4];
        zero_acc(part);
        prod_cb<D>(part, sc, Kst, g, t);
        add_acc(dqa, part);
        __syncthreads();            // before the ring slot is reloaded
    }
    cp_async_wait<0>();

    const long long oa = (((long long)b * S + ra) * H + h) * D + 2 * t;
    const long long ob = oa + 8 * qstride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
        if (ra < S)
            *reinterpret_cast<float2*>(dq + oa + 8 * n) =
                make_float2(dqa[n][0] * scale, dqa[n][1] * scale);
        if (rb < S)
            *reinterpret_cast<float2*>(dq + ob + 8 * n) =
                make_float2(dqa[n][2] * scale, dqa[n][3] * scale);
    }
}

// D = 128, 192: eight warps; the pair (w, w + 4) shares 16 q rows, each
// warp S and dP over half of the key tile, then dS . K over half of dq's
// columns with the pair's whole dS
template <int D, bool CAP>
__device__ __forceinline__ void fb_dq_wide(FB_DQ_PARAMS) {
    constexpr int RS = D + 4;
    constexpr int TILE = fb_tile<D>();
    constexpr int NT = fb_threads<D>();
    constexpr int BM = fb_mrows<D, false>();   // keys a tile
    constexpr int MT = BM * RS;                // floats of a K or V tile
    constexpr int NW = BM / 16;                // 8-key slices a warp
    constexpr int DH = D / 2;                  // dq columns a warp
    extern __shared__ float4 fb_smem4[];
    float* Qs = reinterpret_cast<float*>(fb_smem4);   // [64][RS]
    float* DOs = Qs + TILE;                            // [64][RS]
    float* ring = DOs + TILE;                          // stages x (K, V)
    float4* ex = reinterpret_cast<float4*>(ring + FB_STAGES * 2 * MT);
    __shared__ float dl_s[FB_BQ];
    __shared__ int range_lo, range_hi;

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int pr = warp & 3, hf = warp >> 2;   // the pair; the half
    const int g = lane >> 2, t = lane & 3;
    const int n_qt = (S + FB_BQ - 1) / FB_BQ;
    const int bh = gridDim.x / n_qt;                   // B * H
    const int qt = n_qt - 1 - (int)(blockIdx.x / bh);
    const int h = (int)(blockIdx.x % bh) % H;
    const int b = (int)(blockIdx.x % bh) / H;
    const int hk = h / (H / Hkv);
    const int q0 = qt * FB_BQ;
    const long long qstride = (long long)H * D;
    const long long qbase = (((long long)b * S + q0) * H + h) * D;

    stage_rows<D, 64, NT>(Qs, q + qbase, qstride, S - q0, tid);
    stage_rows<D, 64, NT>(DOs, dout + qbase, qstride, S - q0, tid);
    cp_async_commit();
    const long long rsa = ((long long)b * H + h) * S;
    if (tid < 2 * FB_BQ)
        fb_delta_rows<D>(o, dout, delta, dl_s, qbase, qstride, rsa, q0, S,
                         tid);
    if (tid == 0)
        fb_key_range(q0, S, T_len, causal, window, q_offset, range_lo,
                     range_hi);
    __syncthreads();

    const int ra = q0 + 16 * pr + g, rb = ra + 8;
    int lo_a, hi_a, lo_b, hi_b;
    fb_band(q_offset + ra, T_len, causal, window, lo_a, hi_a);
    fb_band(q_offset + rb, T_len, causal, window, lo_b, hi_b);
    if (ra >= S) hi_a = lo_a;
    if (rb >= S) hi_b = lo_b;
    const float lse_a = ra < S ? lse[rsa + ra] : 0.0f;
    const float lse_b = rb < S ? lse[rsa + rb] : 0.0f;
    const float dl_a = dl_s[16 * pr + g], dl_b = dl_s[16 * pr + g + 8];

    const int t_start = (range_lo / BM) * BM;
    const int n_kt = range_hi > t_start ? (range_hi - t_start + BM - 1) / BM
                                        : 0;
    const long long kvstride = (long long)Hkv * D;
    const long long kvbase = ((long long)b * T_len * Hkv + hk) * D;
    auto load_kv = [&](int i) {
        const int t0 = t_start + BM * i;
        float* Kst = ring + (i % FB_STAGES) * 2 * MT;
        stage_rows<D, BM, NT>(Kst, k + kvbase + t0 * kvstride, kvstride,
                              T_len - t0, tid);
        stage_rows<D, BM, NT>(Kst + MT, v + kvbase + t0 * kvstride, kvstride,
                              T_len - t0, tid);
    };
    if (n_kt > 0) load_kv(0);
    cp_async_commit();

    float dqa[DH / 8][4];
    zero_acc(dqa);
    const uint32_t q_row = fb_smem(Qs + 16 * pr * RS);
    const uint32_t do_row = fb_smem(DOs + 16 * pr * RS);
    float4* pex = ex + pr * (BM / 8) * 32;     // the pair's dS
    const int m0 = hf * (BM / 2);              // the warp's first key

    for (int i = 0; i < n_kt; ++i) {
        if (i + 1 < n_kt) load_kv(i + 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const float* Kst = ring + (i % FB_STAGES) * 2 * MT;
        const float* Vst = Kst + MT;
        const int t0 = t_start + BM * i;

        float sc[NW][4];
        zero_acc(sc);
        prod_abt<D, NW, FB_WIDE_UNROLL>(sc, q_row, fb_smem(Kst + m0 * RS),
                                        lane);
        fb_p_rows<NW, CAP>(sc, t0 + m0, t, lo_a, hi_a, lo_b, hi_b, lse_a,
                           lse_b, scale, cap);
        float dp[NW][4];
        zero_acc(dp);
        prod_abt<D, NW, FB_WIDE_UNROLL>(dp, do_row, fb_smem(Vst + m0 * RS),
                                        lane);
        fb_ds_rows<NW>(sc, dp, dl_a, dl_b);
        fx_put<NW>(pex, sc, hf * NW, lane);
        fx_pair_sync(pr);
        float ds[BM / 8][4];
        fx_get<BM / 8>(ds, pex, lane);
        float part[DH / 8][4];
        zero_acc(part);
        prod_cb<D, DH / 8, BM / 8>(part, ds, Kst + hf * DH, g, t);
        add_acc(dqa, part);
        __syncthreads();        // before the ring slot and exchange reload
    }
    cp_async_wait<0>();

    const long long oa =
        (((long long)b * S + ra) * H + h) * D + hf * DH + 2 * t;
    const long long ob = oa + 8 * qstride;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
        if (ra < S)
            *reinterpret_cast<float2*>(dq + oa + 8 * n) =
                make_float2(dqa[n][0] * scale, dqa[n][1] * scale);
        if (rb < S)
            *reinterpret_cast<float2*>(dq + ob + 8 * n) =
                make_float2(dqa[n][2] * scale, dqa[n][3] * scale);
    }
}

// CAP: with a logit softcap `cap` > 0 (flash_attention_bwd_softcap.cu)
template <int D, bool CAP>
__global__ void __launch_bounds__(D <= 64 ? FB_THREADS : 2 * FB_THREADS,
                                  D <= 64 ? 2 : 1)
fa_bwd_dq_kernel(FB_DQ_PARAMS) {
    if constexpr (D <= 64)
        fb_dq_narrow<D, CAP>(FB_DQ_PASS);
    else
        fb_dq_wide<D, CAP>(FB_DQ_PASS);
}

// ---- dk, dv --------------------------------------------------------------

#define FB_KV_PARAMS const float* __restrict__ q, \
    const float* __restrict__ k, const float* __restrict__ v, \
    const float* __restrict__ dout, const float* __restrict__ lse, \
    const float* __restrict__ delta, float* __restrict__ dk, \
    float* __restrict__ dv, int S, int T_len, int H, int Hkv, int causal, \
    int window, int q_offset, float scale, float cap
#define FB_KV_PASS q, k, v, dout, lse, delta, dk, dv, S, T_len, H, Hkv, \
    causal, window, q_offset, scale, cap

// The q tiles of M rows a key tile [k0, k1) visits: rows whose band
// meets it have absolute positions p in [pa, pb) (the bands' ends grow
// with p), and rows that see no key (only under a window: p >= T +
// window - 1) come after them; tiles [ta0, ta1), then [te, n_qt).
struct FbWalk {
    int ta0, na, te;
    __device__ __forceinline__ int tile(int j) const {
        return j < na ? ta0 + j : te + j - na;
    }
};

template <int M>
__device__ __forceinline__ FbWalk fb_walk(int k0, int k1, int S, int T_len,
                                          int causal, int window,
                                          int q_offset, int& n_tiles) {
    const int n_qt = (S + M - 1) / M;
    const long long pa = causal ? k0 : 0;
    const long long pb = window > 0 ? (long long)k1 + window - 1
                                    : (long long)q_offset + S;
    const long long ra = max(0LL, pa - q_offset);
    const long long rb = min((long long)S, pb - q_offset);
    int ta0 = 0, ta1 = 0;
    if (ra < rb) {
        ta0 = (int)(ra / M);
        ta1 = (int)((rb - 1) / M) + 1;
    }
    int te = n_qt;
    if (window > 0) {
        const long long re =
            max(0LL, (long long)T_len + window - 1 - q_offset);
        if (re < S) te = max(ta1, (int)(re / M));
    }
    n_tiles = ta1 - ta0 + n_qt - te;
    return FbWalk{ta0, ta1 - ta0, te};
}

// D <= 64: four warps, each 16 keys against the whole 64-row q tile.
// CAP: the scores capped (fb_p_cols, fb_ds_cols)
template <int D, bool CAP>
__device__ __forceinline__ void fb_dkdv_narrow(FB_KV_PARAMS) {
    constexpr int RS = D + 4;
    constexpr int TILE = fb_tile<D>();
    constexpr int ITEM = 2 * TILE + 2 * 64;   // q, dO [64][RS], lse, delta
    extern __shared__ float4 fb_smem4[];
    float* Ks = reinterpret_cast<float*>(fb_smem4);   // [64][RS]
    float* Vs = Ks + TILE;                             // [64][RS]
    float* ring = Vs + TILE;                           // stages x items

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int n_kt = (T_len + FB_BK - 1) / FB_BK;
    const int bh = gridDim.x / n_kt;                   // B * Hkv
    const int kt = (int)(blockIdx.x / bh);
    const int hk = (int)(blockIdx.x % bh) % Hkv;
    const int b = (int)(blockIdx.x % bh) / Hkv;
    const int rep = H / Hkv;
    const int k0 = kt * FB_BK;
    const int k1 = min(T_len, k0 + FB_BK);
    const float inv_t = 1.0f / (float)T_len;
    const long long kvstride = (long long)Hkv * D;
    const long long kvbase = (((long long)b * T_len + k0) * Hkv + hk) * D;

    stage_rows<D>(Ks, k + kvbase, kvstride, T_len - k0, tid);
    stage_rows<D>(Vs, v + kvbase, kvstride, T_len - k0, tid);
    cp_async_commit();

    int n_tiles;
    const FbWalk walk = fb_walk<FB_BQ>(k0, k1, S, T_len, causal, window,
                                       q_offset, n_tiles);
    const int n_items = n_tiles * rep;

    const long long qstride = (long long)H * D;
    auto load_item = [&](int i) {
        const int r0 = walk.tile(i / rep) * FB_BQ;
        const int h = hk * rep + i % rep;
        float* st = ring + (i % FB_STAGES) * ITEM;
        const long long qbase = (((long long)b * S + r0) * H + h) * D;
        stage_rows<D>(st, q + qbase, qstride, S - r0, tid);
        stage_rows<D>(st + TILE, dout + qbase, qstride, S - r0, tid);
        if (tid < FB_BQ) {
            const bool ok = r0 + tid < S;
            const long long rs =
                ok ? ((long long)b * H + h) * S + r0 + tid : 0;
            cp_async4(fb_smem(st + 2 * TILE + tid), lse + rs, ok);
            cp_async4(fb_smem(st + 2 * TILE + 64 + tid), delta + rs, ok);
        }
    };
    if (n_items > 0) load_item(0);
    cp_async_commit();

    // this thread's two keys: ka (fragment rows g) and kb (g + 8)
    const int ka = k0 + 16 * warp + g, kb = ka + 8;
    float dka[D / 8][4], dva[D / 8][4];
    zero_acc(dka);
    zero_acc(dva);
    const uint32_t k_row = fb_smem(Ks + 16 * warp * RS);
    const uint32_t v_row = fb_smem(Vs + 16 * warp * RS);

    for (int i = 0; i < n_items; ++i) {
        if (i + 1 < n_items) load_item(i + 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const float* Qst = ring + (i % FB_STAGES) * ITEM;
        const float* DOst = Qst + TILE;
        const float* lse_st = Qst + 2 * TILE;
        const float* dl_st = lse_st + 64;
        const int r0 = walk.tile(i / rep) * FB_BQ;

        // S^T: fragment rows are keys, columns q rows
        float sc[8][4];
        zero_acc(sc);
        prod_abt<D>(sc, k_row, fb_smem(Qst), lane);
        const uint32_t empty =
            fb_p_cols<8, CAP>(sc, r0, lse_st, ka, kb, t, S, T_len, causal,
                              window, q_offset, scale, inv_t, cap);
        float part_acc[D / 8][4];
        zero_acc(part_acc);
        prod_cb<D>(part_acc, sc, DOst, g, t);          // dv += P^T . dO
        add_acc(dva, part_acc);

        float dp[8][4];
        zero_acc(dp);
        prod_abt<D>(dp, v_row, fb_smem(DOst), lane);
        fb_ds_cols<8, CAP>(dp, sc, dl_st, empty, t, lse_st, cap);
        zero_acc(part_acc);
        prod_cb<D>(part_acc, dp, Qst, g, t);           // dk += dS^T . q
        add_acc(dka, part_acc);
        __syncthreads();            // before the ring slot is reloaded
    }
    cp_async_wait<0>();

    const long long oa = (((long long)b * T_len + ka) * Hkv + hk) * D + 2 * t;
    const long long ob = oa + 8 * kvstride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
        if (ka < T_len) {
            *reinterpret_cast<float2*>(dk + oa + 8 * n) =
                make_float2(dka[n][0] * scale, dka[n][1] * scale);
            *reinterpret_cast<float2*>(dv + oa + 8 * n) =
                make_float2(dva[n][0], dva[n][1]);
        }
        if (kb < T_len) {
            *reinterpret_cast<float2*>(dk + ob + 8 * n) =
                make_float2(dka[n][2] * scale, dka[n][3] * scale);
            *reinterpret_cast<float2*>(dv + ob + 8 * n) =
                make_float2(dva[n][2], dva[n][3]);
        }
    }
}

// D = 128, 192: eight warps; the pair (w, w + 4) shares 16 keys, each
// warp S^T and dP^T over half of the q tile's rows, then P^T . dO and
// dS^T . q over half of dk's and dv's columns with the pair's whole P
// and dS
template <int D, bool CAP>
__device__ __forceinline__ void fb_dkdv_wide(FB_KV_PARAMS) {
    constexpr int RS = D + 4;
    constexpr int TILE = fb_tile<D>();
    constexpr int NT = fb_threads<D>();
    constexpr int BM = fb_mrows<D, true>();    // q rows an item
    constexpr int MT = BM * RS;                // floats of a q or dO tile
    constexpr int ITEM = 2 * MT + 2 * BM;      // q, dO, lse, delta
    constexpr int NW = BM / 16;                // 8-row slices a warp
    constexpr int DH = D / 2;                  // dk, dv columns a warp
    extern __shared__ float4 fb_smem4[];
    float* Ks = reinterpret_cast<float*>(fb_smem4);   // [64][RS]
    float* Vs = Ks + TILE;                             // [64][RS]
    float* ring = Vs + TILE;                           // stages x items
    float4* ex = reinterpret_cast<float4*>(ring + FB_STAGES * ITEM);

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int pr = warp & 3, hf = warp >> 2;   // the pair; the half
    const int g = lane >> 2, t = lane & 3;
    const int n_kt = (T_len + FB_BK - 1) / FB_BK;
    const int bh = gridDim.x / n_kt;                   // B * Hkv
    const int kt = (int)(blockIdx.x / bh);
    const int hk = (int)(blockIdx.x % bh) % Hkv;
    const int b = (int)(blockIdx.x % bh) / Hkv;
    const int rep = H / Hkv;
    const int k0 = kt * FB_BK;
    const int k1 = min(T_len, k0 + FB_BK);
    const float inv_t = 1.0f / (float)T_len;
    const long long kvstride = (long long)Hkv * D;
    const long long kvbase = (((long long)b * T_len + k0) * Hkv + hk) * D;

    stage_rows<D, 64, NT>(Ks, k + kvbase, kvstride, T_len - k0, tid);
    stage_rows<D, 64, NT>(Vs, v + kvbase, kvstride, T_len - k0, tid);
    cp_async_commit();

    int n_tiles;
    const FbWalk walk = fb_walk<BM>(k0, k1, S, T_len, causal, window,
                                    q_offset, n_tiles);
    const int n_items = n_tiles * rep;

    const long long qstride = (long long)H * D;
    auto load_item = [&](int i) {
        const int r0 = walk.tile(i / rep) * BM;
        const int h = hk * rep + i % rep;
        float* st = ring + (i % FB_STAGES) * ITEM;
        const long long qbase = (((long long)b * S + r0) * H + h) * D;
        stage_rows<D, BM, NT>(st, q + qbase, qstride, S - r0, tid);
        stage_rows<D, BM, NT>(st + MT, dout + qbase, qstride, S - r0, tid);
        if (tid < BM) {
            const bool ok = r0 + tid < S;
            const long long rs =
                ok ? ((long long)b * H + h) * S + r0 + tid : 0;
            cp_async4(fb_smem(st + 2 * MT + tid), lse + rs, ok);
            cp_async4(fb_smem(st + 2 * MT + BM + tid), delta + rs, ok);
        }
    };
    if (n_items > 0) load_item(0);
    cp_async_commit();

    const int ka = k0 + 16 * pr + g, kb = ka + 8;
    float dka[DH / 8][4], dva[DH / 8][4];
    zero_acc(dka);
    zero_acc(dva);
    const uint32_t k_row = fb_smem(Ks + 16 * pr * RS);
    const uint32_t v_row = fb_smem(Vs + 16 * pr * RS);
    float4* pex = ex + pr * 2 * (BM / 8) * 32;  // the pair's P, then dS
    float4* dsex = pex + (BM / 8) * 32;
    const int m0 = hf * (BM / 2);               // the warp's first q row

    for (int i = 0; i < n_items; ++i) {
        if (i + 1 < n_items) load_item(i + 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const float* Qst = ring + (i % FB_STAGES) * ITEM;
        const float* DOst = Qst + MT;
        const float* lse_st = Qst + 2 * MT;
        const float* dl_st = lse_st + BM;
        const int r0 = walk.tile(i / rep) * BM;

        float sc[NW][4];
        zero_acc(sc);
        prod_abt<D, NW, FB_WIDE_UNROLL>(sc, k_row, fb_smem(Qst + m0 * RS),
                                        lane);
        const uint32_t empty =
            fb_p_cols<NW, CAP>(sc, r0 + m0, lse_st + m0, ka, kb, t, S, T_len,
                               causal, window, q_offset, scale, inv_t, cap);
        float dp[NW][4];
        zero_acc(dp);
        prod_abt<D, NW, FB_WIDE_UNROLL>(dp, v_row, fb_smem(DOst + m0 * RS),
                                        lane);
        fb_ds_cols<NW, CAP>(dp, sc, dl_st + m0, empty, t, lse_st + m0, cap);
        fx_put<NW>(pex, sc, hf * NW, lane);
        fx_put<NW>(dsex, dp, hf * NW, lane);
        fx_pair_sync(pr);

        float c[BM / 8][4], part[DH / 8][4];
        fx_get<BM / 8>(c, pex, lane);
        zero_acc(part);
        prod_cb<D, DH / 8, BM / 8>(part, c, DOst + hf * DH, g, t);  // dv
        add_acc(dva, part);
        fx_get<BM / 8>(c, dsex, lane);
        zero_acc(part);
        prod_cb<D, DH / 8, BM / 8>(part, c, Qst + hf * DH, g, t);   // dk
        add_acc(dka, part);
        __syncthreads();        // before the ring slot and exchange reload
    }
    cp_async_wait<0>();

    const long long oa =
        (((long long)b * T_len + ka) * Hkv + hk) * D + hf * DH + 2 * t;
    const long long ob = oa + 8 * kvstride;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
        if (ka < T_len) {
            *reinterpret_cast<float2*>(dk + oa + 8 * n) =
                make_float2(dka[n][0] * scale, dka[n][1] * scale);
            *reinterpret_cast<float2*>(dv + oa + 8 * n) =
                make_float2(dva[n][0], dva[n][1]);
        }
        if (kb < T_len) {
            *reinterpret_cast<float2*>(dk + ob + 8 * n) =
                make_float2(dka[n][2] * scale, dka[n][3] * scale);
            *reinterpret_cast<float2*>(dv + ob + 8 * n) =
                make_float2(dva[n][2], dva[n][3]);
        }
    }
}

// CAP: with a logit softcap `cap` > 0 (flash_attention_bwd_softcap.cu)
template <int D, bool CAP>
__global__ void __launch_bounds__(D <= 64 ? FB_THREADS : 2 * FB_THREADS,
                                  D <= 64 ? 2 : 1)
fa_bwd_dkdv_kernel(FB_KV_PARAMS) {
    if constexpr (D <= 64)
        fb_dkdv_narrow<D, CAP>(FB_KV_PASS);
    else
        fb_dkdv_wide<D, CAP>(FB_KV_PASS);
}

// ---- launches ------------------------------------------------------------

// CAP: with a softcap `cap` > 0 (flash_attention_bwd_softcap.cu's
// instantiations)
template <int D, bool CAP = false>
static int launch_dq(const float* q, const float* k, const float* v,
                     const float* o, const float* dout, const float* lse,
                     float* delta, float* dq, int B, int S, int T_len, int H,
                     int Hkv, int causal, int window, int q_offset,
                     float scale, cudaStream_t stream, float cap = 0.0f) {
    const int smem = fb_dq_smem_floats<D>() * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        fa_bwd_dq_kernel<D, CAP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const long long blocks =
        (long long)((S + FB_BQ - 1) / FB_BQ) * H * B;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    fa_bwd_dq_kernel<D, CAP><<<(unsigned)blocks, fb_threads<D>(), smem,
                               stream>>>(
        q, k, v, o, dout, lse, delta, dq, S, T_len, H, Hkv, causal, window,
        q_offset, scale, cap);
    return (int)cudaGetLastError();
}

template <int D, bool CAP = false>
static int launch_dkdv(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse,
                       const float* delta, float* dk, float* dv, int B,
                       int S, int T_len, int H, int Hkv, int causal,
                       int window, int q_offset, float scale,
                       cudaStream_t stream, float cap = 0.0f) {
    const int smem = fb_dkdv_smem_floats<D>() * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        fa_bwd_dkdv_kernel<D, CAP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const long long blocks =
        (long long)((T_len + FB_BK - 1) / FB_BK) * Hkv * B;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    fa_bwd_dkdv_kernel<D, CAP><<<(unsigned)blocks, fb_threads<D>(), smem,
                                 stream>>>(
        q, k, v, dout, lse, delta, dk, dv, S, T_len, H, Hkv, causal, window,
        q_offset, scale, cap);
    return (int)cudaGetLastError();
}

// The kernels end here: flash_attention_bwd_softcap.cu includes this
// file with FB_KERNELS_ONLY defined, for the CAP instantiations alone.
#ifndef FB_KERNELS_ONLY

// The pair with a logit softcap > 0: defined in
// flash_attention_bwd_softcap.cu, linked into this library; the
// arguments of launch_dq / launch_dkdv, then D
int fb_dq_softcap(const float* q, const float* k, const float* v,
                  const float* o, const float* dout, const float* lse,
                  float* delta, float* dq, int B, int S, int T_len, int H,
                  int Hkv, int causal, int window, int q_offset, float scale,
                  cudaStream_t stream, float cap, int D);
int fb_dkdv_softcap(const float* q, const float* k, const float* v,
                    const float* dout, const float* lse, const float* delta,
                    float* dk, float* dv, int B, int S, int T_len, int H,
                    int Hkv, int causal, int window, int q_offset,
                    float scale, cudaStream_t stream, float cap, int D);

static bool fb_shape_ok(int B, int S, int T_len, int H, int Hkv,
                        int q_offset) {
    return B >= 1 && S >= 1 && T_len >= 1 && H >= 1 && Hkv >= 1
           && H % Hkv == 0 && q_offset >= 0;
}

static bool fb_aligned(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 0, or a finite cap > 0 on the scores (the forward's, whose lse it is)
static bool fb_softcap_ok(float softcap) {
    return softcap >= 0.0f && !isinf(softcap);
}

// q, o, dout, dq (B,S,H,D), k, v (B,T,Hkv,D), lse and delta (B,H,S), all
// contiguous f32, q, k, v, o, dout and dq on 16-byte addresses; D in
// {16, 32, 64, 80, 128, 192}.  Writes dq and delta = rowsum(dout * o).
// softcap: 0, or the forward's cap > 0, which takes the CAP
// instantiations of flash_attention_bwd_softcap.cu.  Returns
// cudaGetLastError() after the launch; does not synchronise.
extern "C" int flash_attention_bwd_dq_f32(
        const void* q, const void* k, const void* v, const void* o,
        const void* dout, const void* lse, void* delta, void* dq, int B,
        int S, int T_len, int H, int Hkv, int D, int causal, int window,
        int q_offset, float scale, void* stream, float softcap) {
    if (!fb_shape_ok(B, S, T_len, H, Hkv, q_offset)
            || !fb_aligned(q) || !fb_aligned(k) || !fb_aligned(v)
            || !fb_aligned(o) || !fb_aligned(dout) || !fb_aligned(dq)
            || !fb_softcap_ok(softcap))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FB_DQ_ARGS static_cast<const float*>(q), static_cast<const float*>(k), \
    static_cast<const float*>(v), static_cast<const float*>(o), \
    static_cast<const float*>(dout), static_cast<const float*>(lse), \
    static_cast<float*>(delta), static_cast<float*>(dq), B, S, T_len, H, \
    Hkv, causal, window, q_offset, scale, s
    if (softcap > 0.0f) return fb_dq_softcap(FB_DQ_ARGS, softcap, D);
    switch (D) {
        case 16: return launch_dq<16>(FB_DQ_ARGS);
        case 32: return launch_dq<32>(FB_DQ_ARGS);
        case 64: return launch_dq<64>(FB_DQ_ARGS);
        case 80: return launch_dq<80>(FB_DQ_ARGS);
        case 128: return launch_dq<128>(FB_DQ_ARGS);
        case 192: return launch_dq<192>(FB_DQ_ARGS);
    }
#undef FB_DQ_ARGS
    return (int)cudaErrorInvalidValue;
}

// q, dout (B,S,H,D), k, v, dk, dv (B,T,Hkv,D), lse and delta (B,H,S) --
// delta as flash_attention_bwd_dq_f32 wrote it, so launched after it on
// the same stream -- all contiguous f32, q, k, v, dout, dk and dv on
// 16-byte addresses; D in {16, 32, 64, 80, 128, 192}.  Writes dk and dv, each summed
// over the kv head's group of q heads.  softcap as the dq entry's.
extern "C" int flash_attention_bwd_dkdv_f32(
        const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv, int B,
        int S, int T_len, int H, int Hkv, int D, int causal, int window,
        int q_offset, float scale, void* stream, float softcap) {
    if (!fb_shape_ok(B, S, T_len, H, Hkv, q_offset)
            || !fb_aligned(q) || !fb_aligned(k) || !fb_aligned(v)
            || !fb_aligned(dout) || !fb_aligned(dk) || !fb_aligned(dv)
            || !fb_softcap_ok(softcap))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FB_KV_ARGS static_cast<const float*>(q), static_cast<const float*>(k), \
    static_cast<const float*>(v), static_cast<const float*>(dout), \
    static_cast<const float*>(lse), static_cast<const float*>(delta), \
    static_cast<float*>(dk), static_cast<float*>(dv), B, S, T_len, H, Hkv, \
    causal, window, q_offset, scale, s
    if (softcap > 0.0f) return fb_dkdv_softcap(FB_KV_ARGS, softcap, D);
    switch (D) {
        case 16: return launch_dkdv<16>(FB_KV_ARGS);
        case 32: return launch_dkdv<32>(FB_KV_ARGS);
        case 64: return launch_dkdv<64>(FB_KV_ARGS);
        case 80: return launch_dkdv<80>(FB_KV_ARGS);
        case 128: return launch_dkdv<128>(FB_KV_ARGS);
        case 192: return launch_dkdv<192>(FB_KV_ARGS);
    }
#undef FB_KV_ARGS
    return (int)cudaErrorInvalidValue;
}

template <int D>
static long long fb_sizes(int kernel, int which) {
    const bool dkdv = kernel == 1;
    switch (which) {
        case 0: return fb_threads<D>() / 32;
        case 1: return 4LL * (dkdv ? fb_dkdv_smem_floats<D>()
                                   : fb_dq_smem_floats<D>());
        case 2: return dkdv ? fb_mrows<D, true>() : fb_mrows<D, false>();
        case 3: return FB_STAGES;
        case 4: return 1;
        case 5: return dkdv ? 4 : 3;
        default: return -1;
    }
}

// The launch of one kernel at head dim D (kernel 0: dq, 1: dkdv): which
// = 0, warps a block; 1, bytes of dynamic shared memory; 2, rows of a
// moving tile (keys in dq, q rows in dkdv); 3, stages of its ring; 4,
// the grid's y; 5, the D-long dots it computes a visible (q, k) pair.
// -1 for a D, kernel or which it does not have.
extern "C" long long flash_attention_bwd_sizes(int D, int kernel,
                                               int which) {
    if (kernel != 0 && kernel != 1) return -1;
    switch (D) {
        case 16: return fb_sizes<16>(kernel, which);
        case 32: return fb_sizes<32>(kernel, which);
        case 64: return fb_sizes<64>(kernel, which);
        case 80: return fb_sizes<80>(kernel, which);
        case 128: return fb_sizes<128>(kernel, which);
        case 192: return fb_sizes<192>(kernel, which);
    }
    return -1;
}

#endif  // FB_KERNELS_ONLY
