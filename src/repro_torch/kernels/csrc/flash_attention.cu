// Blockwise online-softmax attention for Hopper (sm_90a), GQA-aware:
// two kernels, picked by the dtype.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// _kernel / flash_attention (and the GQA wrapper of kernels/ops.py,
// which repeated k/v per group first).  That kernel walks a (BH, nq, nk)
// grid with the KV axis sequential and keeps (acc, m, l) in VMEM
// scratch between grid steps; here one block owns one (b, h, q tile)
// and loops over the key tiles its rows can see, the online-softmax
// state of each row in f32 registers.
//
//   q (B,S,H,D), k/v (B,T,Hkv,D), strides with a unit stride on D;
//   out (B,S,H,D) contiguous, in q's type.  Query head h reads kv head
//   h / (H/Hkv) -- the mapping of jnp.repeat(k, H/Hkv, axis=2) -- and no
//   repeated copy of k or v is ever made.
//
//   s = (q . k) * scale            scale = 1/sqrt(D) multiplied AFTER
//                                  the dot
//   s = visible ? s : -1e30        a select, not an additive bias;
//                                  causal: k_pos <= q_pos, window > 0:
//                                  k_pos > q_pos - window, positions
//                                  absolute with q_pos = q_offset + row
//   m_new = max(m, max_j s_j),  p_j = exp(s_j - m_new),
//   corr = exp(m - m_new),  l = l*corr + sum p,  acc = acc*corr + p.v
//   out = acc / max(l, 1e-30)
//
// Both kernels skip key tiles wholly outside every row's causal/window
// band -- except in a block that holds a row that sees no key at all:
// the reference gives such a row exp(-1e30 - (-1e30)) = 1 for every
// key, i.e. the mean of v over all T keys, so that block walks all T
// keys, as the reference's grid does.  Keys past T (a tail tile) get
// -inf and zero k/v, so they add nothing even to such a row.
//
// f32: fa_fwd_f32_kernel<D, LSE>, on the tensor cores in split TF32
// (the design of flash_attention_bwd.cu's kernels).  Per visible pair
// 4*D f32 flops (two dots) and one exp; each f32 product is three TF32
// products on the tensor cores (494.7e12 TF32 flop/s), against 67e12 on
// the CUDA cores, so split TF32 bounds it.
//   * A block of 4 warps owns 64 q rows of one (b, h), 16 rows a warp;
//     a 1-D grid, the last q tiles first (under a causal mask they see
//     the most keys).  Two blocks an SM.
//   * q is split once into split-TF32 A fragments: x = hi + lo, each
//     part rounded to nearest TF32 (tf32_split.cuh, shared with the
//     backward pair); a product a.b is lo.hi + hi.lo + hi.hi (about
//     2^-21 relative, of either sign, where one TF32 product, about
//     2^-10, fails FA_TOL f32).  The fragments sit in shared memory, each
//     thread's own (32 KB a block at D = 64), read back a k-step at a
//     time: in registers they took 64 a thread, and the score products'
//     sums from zero then spilled.
//   * K and V tiles of 64 keys come in by 16-byte cp.async into a
//     2-stage ring (the next tile loading under this one's products),
//     rows padded to D+4 floats (ldmatrix rows and scalar B words free
//     of bank conflicts); keys past T are zero-filled by the copy.
//   * S = Q.K^T: mma.sync.m16n8k8 TF32, K's fragments by ldmatrix, each
//     k-step's three products summed from zero and added in f32 (the
//     tensor cores round a chained sum toward zero at the running sum's
//     magnitude, too far on scores of large terms), above D = 64 the odd
//     k-steps in a second sum (tf32_mma.cuh: score_step, shared with the
//     backward pair); then * scale, the masks by select, and the online
//     softmax on the C fragments (row max and sum over the quad that
//     holds a row; p = expf(s - m), corr = expf(m - m_new), as the
//     reference).
//   * O = O * corr + P.V: P leaves S as C fragments and is P.V's A
//     operand with each 8-key slice's contraction index permuted (slot
//     t <-> 2t, t+4 <-> 2t+1), V's rows read in that order.  Each tile's
//     product is summed from zero on the tensor cores and then added in
//     f32: their own adds round toward zero, a drift that grows with
//     the tiles (flash_attention_bwd.cu).
//   * Epilogue: out = acc / max(l, 1e-30), row-major f32 stores of rows
//     < S; with LSE, lse = m + log(max(l, 1e-30)) for the backward.
//   * k and v need 16-byte addresses and strides (cp.async); the
//     wrapper raises otherwise.  q is read with 4-byte loads.
//   * D = 80, 128 and 192 (the same arithmetic, fa_fwd_wide): q as
//     split-TF32 fragments would take D registers a thread (at D = 64
//     the four-warp kernel already holds 252), so q sits in shared
//     memory and its fragments are read by ldmatrix and split each tile.
//     Eight warps a block (one block an SM: eight warps), the pair of
//     warps w, w + 4 sharing 16 q rows: each computes S over half of
//     the key tile's columns, the pair takes the common row max through
//     shared memory behind a barrier of its 64 threads (bar.sync 1 +
//     pair, 64), each forms P on its fragments and puts it in the
//     pair's exchange (fa_exchange.cuh: a float4 a lane and 8-key
//     slice, as the backward's), and after a second pair barrier each
//     runs P.V with the pair's whole 16-row P (split once a tile) over
//     its half of the output columns, D/2 = 40, 64 or 96 (20, 32 or 48
//     accumulator registers).  So S once a visible pair: 2 dots, as at
//     D <= 64, and no grid y.  l is a per-thread partial sum over the
//     warp's keys, summed over the quad and the pair in the epilogue.
//     V's B words stay two scalar loads a fragment (ldmatrix cannot
//     transpose 32-bit words), free of bank conflicts.  A 2-stage ring
//     of K/V tiles of 64 keys (D = 80, 128) or 48 (D = 192); bytes of
//     dynamic shared memory:
//
//       D = 80:  q 64*84*4 = 21,504; ring 2*2*64*84*4 = 86,016; P
//                exchange 16,384; row exchange 512; in all 124,416
//       D = 128: q 64*132*4 = 33,792; ring 2*2*64*132*4 = 135,168; P
//                exchange 4 pairs * 64 keys * 16 floats * 4 = 16,384;
//                row exchange 4*2*16*4 = 512; in all 185,856
//       D = 192: q 64*196*4 = 50,176; ring 2*2*48*196*4 = 150,528;
//                exchange 4*48*16*4 = 12,288; 512; in all 213,504
//                (of 232,448; 64-key tiles would need 251 KB, 32-key
//                ones took 4 % longer on an H100: PERF.md)
//
//     flash_attention_fwd_sizes reports these launches.  No spills.
//
// bf16: flash_attention_tc_kernel, on the tensor cores.  Per visible
// (q, k) pair the work is 4*D flops (two dots) and one exp, so at D=64
// the tensor cores (989e12 flop/s: 3.86e12 pairs/s) and the special-
// function units' exp2 (16 a clock an SM: 4.18e12/s) bound it almost
// equally; the bytes (q, k, v, out once) are two orders below.
//   * A CTA owns 128 q rows of one (b, h): warpgroup 0 is the producer,
//     warpgroups 1 and 2 the consumers, 64 rows each.  setmaxnreg moves
//     registers from the producer (24) to the consumers (240).
//   * One producer thread loads the Q tile once and keeps K and V tiles
//     of 128 keys in flight in a ring of 3 stages with TMA
//     (cp.async.bulk.tensor, 4-D maps over (D, T, Hkv, B) with the
//     caller's strides, encoded on the host through the driver's entry
//     point and cached), each stage with full and empty mbarriers; so
//     the loads of tiles j+1 and j+2 are in flight while tile j is
//     computed.  TMA's out-of-bounds fill gives the zero rows past S
//     and the zero k/v past T.  Tiles land in the swizzle of one D-wide
//     row (128, 64 or 32 bytes for D = 64, 32, 16), the layout wgmma
//     reads; at D = 128 and 192 in blocks of 64 columns (one 128-byte
//     swizzled TMA box each), the descriptors stepping across them.
//     At D = 80 a row is 160 bytes, no multiple of the 128-byte
//     swizzle: the tiles are five blocks of 16 columns (one 32-byte
//     swizzled box each), a k-step of Q.K^T one block, and P.V one
//     m64n80k16 whose MN-major V descriptor steps across the blocks.
//   * S = Q.K^T: wgmma.mma_async m64n128k16, both operands K-major from
//     shared memory, f32 accumulator in registers; then * scale.
//   * Masks by select only on tiles that cut a band edge or hold keys
//     past T; interior tiles skip them.  Online softmax in f32, row max
//     and sum over the quad that holds a row; p = 2^(s*scale*log2e - m)
//     and corr through ex2.approx -- where the f32 kernel uses expf.
//   * O += P.V: P, kept at f32 precision as two bf16 parts in
//     registers, P_hi = bf16(P) and P_lo = bf16(P - P_hi), is wgmma's A
//     operand (the accumulator's layout is the A fragment's), V an
//     MN-major B operand from shared memory (the transpose bit): two
//     m64nDk16 products per 16 keys on one V descriptor, O += P_hi.V +
//     P_lo.V; O in f32 registers, rescaled by corr before each product.
//   * Epilogue: out = o / max(l, 1e-30), rounded once to bf16, staged
//     in shared memory and stored 16 bytes a thread, rows < S only.
//     With LSE (training: the backward kernels read both) also each
//     row's log-sum-exp in natural units, ln 2 * (m + log2(max(l,
//     1e-30))), m being kept in the scaled log2 domain (a row that sees
//     no key, m = -1e30, takes the f32 kernel's -1e30 + log(l)), and
//     out_lo = bf16(o / l - out), what the rounding of out left: out +
//     out_lo holds o / l to about 2^-16, so the backward's delta =
//     rowsum(dO * O) is taken of the f32 output, as autograd of the f32
//     softmax takes it (of out alone it is off by out's 2^-9, which
//     reaches dq and dk through dS and fails their bf16 tolerance).  It
//     is staged and stored as out is, after it.  No bit of out changes.
//   * Overlap, as FA3 does it: a warpgroup issues tile j's Q.K^T and
//     tile j-1's P.V in one go and runs tile j's softmax while that P.V
//     is on the tensor cores; and "ping-pong": the two consumer
//     warpgroups take turns to issue (named barriers), so one's softmax
//     (the exps: the SFU) runs while the other's products hold the
//     tensor cores.  Measured on an H100 (PERF.md): 5 % under a serial
//     tile loop; the K/V ring alone -- every 128-row block reloading
//     its head's tiles from L2 -- is most of what remains.
//   * ptxas (-Xptxas -v): 168 registers at entry for all five head
//     sizes (384 threads, one block an SM), 24 / 240 after setmaxnreg,
//     no spills; about 131 KB of shared memory at D=64.
//   * D = 128 and 192: q, K and V in swizzled blocks of 64 columns (one
//     128-byte TMA box each); the output staged in the warpgroup's own q
//     rows once its last Q.K^T has been waited on (no O buffer), which
//     buys the ring: at D = 128 K/V tiles of 128 keys in 3 stages (q
//     32,768 + 3 * 65,536 = 229,376 bytes), at D = 192 tiles of 96 keys
//     in 2 stages (49,152 + 2 * 73,728 = 196,608; S, P's two parts and
//     O are 48 + 48 + 96 of the consumers' 240 registers, as D = 128's
//     64 + 64 + 64).  P.V one m64n128k16 / m64n192k16 across V's
//     64-column blocks (one m64n64k16 a block made ptxas serialize the
//     wgmma, C7520, and took 1.7-1.8x the time on an H100: PERF.md).
//     The ring is not what binds there: K/V shared by a 2-CTA cluster
//     through TMA multicast (the `multicast` patch of
//     tools/k4_variants.py) and a third stage at D = 128 each moved
//     nothing or lost on an H100 (PERF.md); the 96-key tiles at D = 192
//     gained 7-16 %.
//   * D = 80 (hubert): as D = 128, in five blocks of 16 columns (32-byte
//     swizzle, Layout::chunk for the staging): 128-key tiles in 3
//     stages (q 20,480 + 3 * 40,960 = 143,360 bytes); S, P's two parts
//     and O are 64 + 64 + 40 registers; P.V one m64n80k16.
// Numerics against the f32 reference: P.V takes P at f32 precision (the
// split leaves about 2^-16 of P; one bf16 part alone would leave 2^-9),
// so the numerator matches the f32 row sum l; exp goes through exp2.  The checks hold it at rtol
// 8e-3, atol 1e-3: the output's one bf16 rounding.  The second product
// costs 17-24 % of the kernel's time on an H100 (PERF.md).
//
// Addresses and byte strides of q, k, v (bf16: TMA) and of k, v (f32:
// cp.async) must be multiples of 16 bytes; the wrapper raises otherwise.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

#include "fa_exchange.cuh"   // fx_pair_sync, fx_put, fx_get
#include "fa_hopper.cuh"     // TMA, mbarriers, wgmma, tensor maps
#include "tf32_split.cuh"    // tf32_split: the f32 kernels' operands
#include "tf32_mma.cuh"      // mma3, score_step: their products

// ---------------------------------------------------------------------
// The f32 kernel: tensor cores (mma.sync TF32), split TF32
// ---------------------------------------------------------------------

#define FA_BQ 64
#define FA_BK 64
#define FA_WARPS 4
#define FA_THREADS (32 * FA_WARPS)
#define FA_NEG (-1e30f)
#define FA_STAGES 2              // stages of the K/V ring, at every D

// threads a block: four warps up to D = 64, eight (four pairs) above
template <int D>
__host__ __device__ constexpr int fa_threads() {
    return D <= 64 ? FA_THREADS : 2 * FA_THREADS;
}

// keys a K/V tile: 64, and 48 at D = 192 (two stages of 64 keys beside
// the q tile would need 251 KB)
template <int D>
__host__ __device__ constexpr int fa_keys() { return D <= 128 ? FA_BK : 48; }

// k-steps of 16 that the wide kernel's S product unrolls (4 spilled
// beside score_step's second sum)
#define FA_WIDE_UNROLL 2

// floats of shared memory: the K/V ring (stages x (K, V), tiles padded
// to D+4); up to D = 64 also q's split A fragments (4 warps x D/8
// k-steps x 32 lanes x hi and lo, a uint4 each); above D = 64 the q tile
// (64 rows padded to D+4), the pairs' P exchange (4 pairs x the tile's
// 8-key slices x 32 lanes x a float4) and their row exchange (4 pairs x
// 2 halves x 16 rows)
template <int D>
__host__ __device__ constexpr int fa_smem_floats() {
    return FA_STAGES * 2 * fa_keys<D>() * (D + 4)
           + (D > 64 ? 64 * (D + 4) + 4 * fa_keys<D>() * 16 + 4 * 2 * 16
                     : FA_WARPS * (D / 8) * 32 * 8);
}

// The keys absolute position p sees: [lo, hi) (empty when hi <= lo).
__device__ __forceinline__ void fa_band(int p, int T_len, int causal,
                                        int window, int& lo, int& hi) {
    lo = window > 0 ? max(0, p - window + 1) : 0;
    hi = causal ? min(T_len, p + 1) : T_len;
}

__device__ __forceinline__ uint32_t fa_smem(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, or 16 zero bytes when !ok
__device__ __forceinline__ void fa_cp_async16(uint32_t dst, const void* src,
                                              bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void fa_cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void fa_cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8 x 4 f32 blocks: lane l gives the row address of block l / 8,
// row l % 8; thread (g = lane/4, t = lane%4) gets element (g, t) of each
__device__ __forceinline__ void fa_ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr) : "memory");
}

template <int N>
__device__ __forceinline__ void fa_zero(float (&a)[N][4]) {
#pragma unroll
    for (int n = 0; n < N; ++n) a[n][0] = a[n][1] = a[n][2] = a[n][3] = 0.0f;
}

// ROWS rows of D floats from global rows (row stride `stride` floats,
// zero-filled from row `n_ok` on) into a padded shared tile, by NT
// threads
template <int D, int ROWS = 64, int NT = FA_THREADS>
__device__ __forceinline__ void fa_stage_rows(float* dst, const float* src,
                                              long long stride, int n_ok,
                                              int tid) {
    constexpr int C4 = D / 4;
#pragma unroll 4
    for (int i = tid; i < ROWS * C4; i += NT) {
        const int r = i / C4, c4 = i % C4;
        const bool ok = r < n_ok;
        fa_cp_async16(fa_smem(dst + r * (D + 4) + 4 * c4),
                      src + (ok ? r * stride + 4 * c4 : 0), ok);
    }
}

#define FA_FWD_PARAMS const float* __restrict__ q, \
    const float* __restrict__ k, const float* __restrict__ v, \
    float* __restrict__ out, float* __restrict__ lse, int S, int T_len, \
    int H, int Hkv, long long q_sb, long long q_ss, long long q_sh, \
    long long k_sb, long long k_st, long long k_sh, long long v_sb, \
    long long v_st, long long v_sh, int causal, int window, int q_offset, \
    float scale, float cap
#define FA_FWD_PASS q, k, v, out, lse, S, T_len, H, Hkv, q_sb, q_ss, q_sh, \
    k_sb, k_st, k_sh, v_sb, v_st, v_sh, causal, window, q_offset, scale, cap

// The logit softcap of the CAP instantiations, cap * tanh(s / cap) on
// the scaled score as the reference writes it (divide, tanh, multiply).
// tanhf is the accurate one (2 ulp): tanh.approx.f32's relative error,
// near 2^-11, times a cap of 50 is about 0.024 of a logit, 2.4 % of p.
template <bool CAP>
__device__ __forceinline__ float fa_softcap(float s, float cap) {
    return CAP ? tanhf(s / cap) * cap : s;
}

// The keys a block of 64 rows from q0 needs, into range_lo / range_hi:
// the union of its rows' bands, or all T when one of its rows sees none
__device__ __forceinline__ void fa_block_range(int q0, int S, int T_len,
                                               int causal, int window,
                                               int q_offset, int& range_lo,
                                               int& range_hi) {
    int lo = T_len, hi = 0;
    bool empty = false;
    for (int rr = 0; rr < FA_BQ && q0 + rr < S; ++rr) {
        int l, u;
        fa_band(q_offset + q0 + rr, T_len, causal, window, l, u);
        if (u <= l) { empty = true; break; }
        lo = min(lo, l);
        hi = max(hi, u);
    }
    range_lo = empty ? 0 : lo;
    range_hi = empty ? T_len : hi;
}

// D <= 64: four warps, 16 q rows a warp, each against the whole key
// tile; q split once into TF32 A fragments kept in shared memory, each
// thread's own (no barrier: a thread reads back only what it wrote), so
// that the registers hold the scores, the output and the products' sums
// from zero.
// LSE: also write each row's m + log(max(l, 1e-30)) to lse (B,H,S).
// CAP: the scores soft-capped (fa_softcap) before the masks; a CAP
// kernel is built with LSE only, and writes lse where it is not null.
template <int D, bool LSE, bool CAP>
__device__ __forceinline__ void fa_fwd_narrow(FA_FWD_PARAMS) {
    constexpr int RS = D + 4;
    constexpr int TILE = FA_BK * RS;
    constexpr int KS = D / 8;                 // k-steps of Q.K^T
    extern __shared__ float4 fa_smem4[];
    float* ring = reinterpret_cast<float*>(fa_smem4);   // stages x (K, V)
    __shared__ int range_lo, range_hi;

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int n_qt = (S + FA_BQ - 1) / FA_BQ;
    const int bh = gridDim.x / n_qt;                   // B * H
    const int qt = n_qt - 1 - (int)(blockIdx.x / bh);
    const int h = (int)(blockIdx.x % bh) % H;
    const int b = (int)(blockIdx.x % bh) / H;
    const int hk = h / (H / Hkv);
    const int q0 = qt * FA_BQ;

    if (tid == 0)
        fa_block_range(q0, S, T_len, causal, window, q_offset, range_lo,
                       range_hi);
    __syncthreads();
    const int t_start = (range_lo / FA_BK) * FA_BK;
    const int n_kt = (range_hi - t_start + FA_BK - 1) / FA_BK;
    const float* kbase = k + (long long)b * k_sb + (long long)hk * k_sh;
    const float* vbase = v + (long long)b * v_sb + (long long)hk * v_sh;
    auto load_kv = [&](int i) {
        const int t0 = t_start + FA_BK * i;
        float* Kst = ring + (i % FA_STAGES) * 2 * TILE;
        fa_stage_rows<D>(Kst, kbase + (long long)t0 * k_st, k_st,
                         T_len - t0, tid);
        fa_stage_rows<D>(Kst + TILE, vbase + (long long)t0 * v_st, v_st,
                         T_len - t0, tid);
    };
    load_kv(0);
    fa_cp_async_commit();

    // this thread's two rows, ra (fragment rows g) and rb (g + 8): their
    // q as split-TF32 A fragments, split once into shared memory: hi
    // and lo of k-step ks at qf[64 * ks] and qf[64 * ks + 32], a warp's
    // lanes side by side
    const int ra = q0 + 16 * warp + g, rb = ra + 8;
    uint4* qf = reinterpret_cast<uint4*>(ring + FA_STAGES * 2 * TILE)
                + warp * KS * 64 + lane;
    {
        const float* qa = q + (long long)b * q_sb + (long long)h * q_sh
                          + (long long)min(ra, S - 1) * q_ss;
        const float* qb = q + (long long)b * q_sb + (long long)h * q_sh
                          + (long long)min(rb, S - 1) * q_ss;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
            const float x0 = ra < S ? qa[8 * ks + t] : 0.0f;
            const float x1 = rb < S ? qb[8 * ks + t] : 0.0f;
            const float x2 = ra < S ? qa[8 * ks + t + 4] : 0.0f;
            const float x3 = rb < S ? qb[8 * ks + t + 4] : 0.0f;
            uint4 h4, l4;
            tf32_split(x0, h4.x, l4.x);
            tf32_split(x1, h4.y, l4.y);
            tf32_split(x2, h4.z, l4.z);
            tf32_split(x3, h4.w, l4.w);
            qf[64 * ks] = h4;
            qf[64 * ks + 32] = l4;
        }
    }
    int lo_a, hi_a, lo_b, hi_b;
    fa_band(q_offset + ra, T_len, causal, window, lo_a, hi_a);
    fa_band(q_offset + rb, T_len, causal, window, lo_b, hi_b);

    float m_a = FA_NEG, m_b = FA_NEG, l_a = 0.0f, l_b = 0.0f;
    float acc[D / 8][4];
    fa_zero(acc);
    const int blk = lane >> 3, r8 = lane & 7;

    for (int i = 0; i < n_kt; ++i) {
        if (i + 1 < n_kt) load_kv(i + 1);
        fa_cp_async_commit();
        fa_cp_async_wait<1>();
        __syncthreads();
        const float* Kst = ring + (i % FA_STAGES) * 2 * TILE;
        const float* Vst = Kst + TILE;
        const int t0 = t_start + FA_BK * i;

        // S = Q.K^T for the warp's 16 rows and the tile's 64 keys
        float sc[8][4];
        fa_zero(sc);
        const uint32_t b_lane = fa_smem(Kst) + (r8 * RS + 4 * blk) * 4;
        // one k-step of 16 at a time: its products' sums from zero (16
        // partial sums) beside the scores, unrolled k-steps spilled
#pragma unroll 1
        for (int k0 = 0; k0 < D; k0 += 16) {
            const uint4 h0 = qf[8 * k0], l0 = qf[8 * k0 + 32];
            const uint4 h1 = qf[8 * k0 + 64], l1 = qf[8 * k0 + 96];
            const uint32_t ah0[4] = {h0.x, h0.y, h0.z, h0.w};
            const uint32_t al0[4] = {l0.x, l0.y, l0.z, l0.w};
            const uint32_t ah1[4] = {h1.x, h1.y, h1.z, h1.w};
            const uint32_t al1[4] = {l1.x, l1.y, l1.z, l1.w};
#pragma unroll
            for (int n = 0; n < 8; ++n) {
                // k-step k0 in words 0-1, k0 + 8 in words 2-3
                uint32_t bw[4], bhi[4], blo[4];
                fa_ldsm_x4(bw, b_lane + (8 * n * RS + k0) * 4);
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    tf32_split(__uint_as_float(bw[e]), bhi[e], blo[e]);
                // one sum up to D = 64: sc[n] takes both k-steps
                score_step<D>(sc[n], sc[n], ah0, al0, ah1, al1, bhi, blo);
            }
        }
        // scale, masks (a select: -1e30 for a masked key, -inf past T),
        // the online softmax of each row over its quad
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = t0 + 8 * n + 2 * t + (e & 1);
                const bool vis = e < 2 ? key >= lo_a && key < hi_a
                                       : key >= lo_b && key < hi_b;
                const float s = vis ? fa_softcap<CAP>(sc[n][e] * scale, cap)
                                    : (key < T_len ? FA_NEG : -INFINITY);
                sc[n][e] = s;
                if (e < 2) mx_a = fmaxf(mx_a, s);
                else mx_b = fmaxf(mx_b, s);
            }
        }
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        float ps_a = 0.0f, ps_b = 0.0f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            sc[n][0] = expf(sc[n][0] - mn_a);
            sc[n][1] = expf(sc[n][1] - mn_a);
            sc[n][2] = expf(sc[n][2] - mn_b);
            sc[n][3] = expf(sc[n][3] - mn_b);
            ps_a += sc[n][0] + sc[n][1];
            ps_b += sc[n][2] + sc[n][3];
        }
        ps_a += __shfl_xor_sync(0xffffffffu, ps_a, 1);
        ps_a += __shfl_xor_sync(0xffffffffu, ps_a, 2);
        ps_b += __shfl_xor_sync(0xffffffffu, ps_b, 1);
        ps_b += __shfl_xor_sync(0xffffffffu, ps_b, 2);
        const float corr_a = expf(m_a - mn_a), corr_b = expf(m_b - mn_b);
        l_a = l_a * corr_a + ps_a;
        l_b = l_b * corr_b + ps_b;
        m_a = mn_a;
        m_b = mn_b;

        // O = O * corr + P.V: the tile's product summed from zero, then
        // added in f32.  P leaves S as C fragments (columns 2t, 2t+1 of
        // each 8-key slice) and is the A operand with the slice's
        // contraction index permuted (slot t <-> 2t, t+4 <-> 2t+1), V's
        // rows read in the same order
        float part[D / 8][4];
        fa_zero(part);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
            uint32_t ah[4], al[4];
            tf32_split(sc[kk][0], ah[0], al[0]);   // (g,   slot t)
            tf32_split(sc[kk][2], ah[1], al[1]);   // (g+8, slot t)
            tf32_split(sc[kk][1], ah[2], al[2]);   // (g,   slot t+4)
            tf32_split(sc[kk][3], ah[3], al[3]);   // (g+8, slot t+4)
            const float* bp = Vst + (8 * kk + 2 * t) * RS + g;
#pragma unroll
            for (int n = 0; n < D / 8; ++n) {
                uint32_t bh0, bl0, bh1, bl1;
                tf32_split(bp[8 * n], bh0, bl0);
                tf32_split(bp[RS + 8 * n], bh1, bl1);
                mma3(part[n], ah, al, bh0, bh1, bl0, bl1);
            }
        }
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
            float (&o)[4] = acc[n];
            o[0] = o[0] * corr_a + part[n][0];
            o[1] = o[1] * corr_a + part[n][1];
            o[2] = o[2] * corr_b + part[n][2];
            o[3] = o[3] * corr_b + part[n][3];
        }
        __syncthreads();            // before the ring slot is reloaded
    }
    fa_cp_async_wait<0>();

    const float la = fmaxf(l_a, 1e-30f), lb = fmaxf(l_b, 1e-30f);
    const long long oa = (((long long)b * S + ra) * H + h) * D + 2 * t;
    const long long ob = oa + 8LL * H * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
        if (ra < S)
            *reinterpret_cast<float2*>(out + oa + 8 * n) =
                make_float2(acc[n][0] / la, acc[n][1] / la);
        if (rb < S)
            *reinterpret_cast<float2*>(out + ob + 8 * n) =
                make_float2(acc[n][2] / lb, acc[n][3] / lb);
    }
    if (LSE && (!CAP || lse != nullptr) && t == 0) {
        const long long rs = ((long long)b * H + h) * S;
        if (ra < S) lse[rs + ra] = m_a + logf(la);
        if (rb < S) lse[rs + rb] = m_b + logf(lb);
    }
}

// acc[n] += A . B^T for the warp's 16 rows of A (at a_row, shared) and
// 8N rows of B (at b_tile, shared), both D wide with stride D+4: S of
// 16 q rows against 8N keys, n-th 8-key slice in acc[n]; A and B by
// ldmatrix, split each k-step; the sums as the pair's prod_abt takes
// them (tf32_mma.cuh: score_step, score_fold); FA_WIDE_UNROLL k-steps
// of 16 unrolled
template <int D, int N, int U = FA_WIDE_UNROLL>
__device__ __forceinline__ void fa_qk_smem(float (&acc)[N][4],
                                           uint32_t a_row, uint32_t b_tile,
                                           int lane) {
    constexpr int RS = D + 4;
    const int blk = lane >> 3, r8 = lane & 7;
    // blocks: rows 0-7 and 8-15 of columns k0.., then of k0 + 4..
    const uint32_t a_lane =
        a_row + ((r8 + 8 * (blk & 1)) * RS + 4 * (blk >> 1)) * 4;
    const uint32_t b_lane = b_tile + (r8 * RS + 4 * blk) * 4;
    float odd[N][4];
    fa_zero(odd);
#pragma unroll (U)
    for (int k0 = 0; k0 < D; k0 += 16) {
        uint32_t a0[4], a1[4], a0h[4], a0l[4], a1h[4], a1l[4];
        fa_ldsm_x4(a0, a_lane + k0 * 4);
        fa_ldsm_x4(a1, a_lane + (k0 + 8) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            tf32_split(__uint_as_float(a0[e]), a0h[e], a0l[e]);
            tf32_split(__uint_as_float(a1[e]), a1h[e], a1l[e]);
        }
#pragma unroll
        for (int n = 0; n < N; ++n) {
            // k-step k0 in words 0-1, k0 + 8 in words 2-3
            uint32_t bw[4], bhi[4], blo[4];
            fa_ldsm_x4(bw, b_lane + (8 * n * RS + k0) * 4);
#pragma unroll
            for (int e = 0; e < 4; ++e)
                tf32_split(__uint_as_float(bw[e]), bhi[e], blo[e]);
            score_step<D>(acc[n], odd[n], a0h, a0l, a1h, a1l, bhi, blo);
        }
    }
    score_fold<D>(acc, odd);
}

// D = 128, 192: eight warps and 64 q rows a block; the pair (w, w + 4)
// shares 16 rows.  Each warp computes S over half of the key tile's
// columns, the pair agrees on the row max through shared memory, each
// forms P on its fragments and puts it in the pair's exchange, and each
// runs P.V with the pair's whole 16-row P over half of the output
// columns.  l is a per-thread partial sum until the epilogue.
template <int D, bool LSE, bool CAP>
__device__ __forceinline__ void fa_fwd_wide(FA_FWD_PARAMS) {
    constexpr int RS = D + 4;
    constexpr int NT = fa_threads<D>();
    constexpr int BK = fa_keys<D>();           // keys a tile
    constexpr int MT = BK * RS;                // floats of a K or V tile
    constexpr int NW = BK / 16;                // 8-key slices of S a warp
    constexpr int DH = D / 2;                  // output columns a warp
    extern __shared__ float4 fa_smem4[];
    float* Qs = reinterpret_cast<float*>(fa_smem4);        // [64][RS]
    float* ring = Qs + FA_BQ * RS;                         // stages x (K, V)
    float4* ex = reinterpret_cast<float4*>(ring + FA_STAGES * 2 * MT);
    float* rx = reinterpret_cast<float*>(ex + 4 * (BK / 8) * 32);
    __shared__ int range_lo, range_hi;

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int pr = warp & 3, hf = warp >> 2;   // the pair; the half
    const int g = lane >> 2, t = lane & 3;
    const int n_qt = (S + FA_BQ - 1) / FA_BQ;
    const int bh = gridDim.x / n_qt;                   // B * H
    const int qt = n_qt - 1 - (int)(blockIdx.x / bh);
    const int h = (int)(blockIdx.x % bh) % H;
    const int b = (int)(blockIdx.x % bh) / H;
    const int hk = h / (H / Hkv);
    const int q0 = qt * FA_BQ;

    if (tid == 0)
        fa_block_range(q0, S, T_len, causal, window, q_offset, range_lo,
                       range_hi);
    // the q tile (4-byte loads: q has no alignment rule), zero rows past S
    const float* qt0 = q + (long long)b * q_sb + (long long)h * q_sh;
    for (int i = tid; i < FA_BQ * D; i += NT) {
        const int r = i / D, c = i % D;
        Qs[r * RS + c] = q0 + r < S ? qt0[(long long)(q0 + r) * q_ss + c]
                                    : 0.0f;
    }
    __syncthreads();
    const int t_start = (range_lo / BK) * BK;
    const int n_kt = (range_hi - t_start + BK - 1) / BK;
    const float* kbase = k + (long long)b * k_sb + (long long)hk * k_sh;
    const float* vbase = v + (long long)b * v_sb + (long long)hk * v_sh;
    auto load_kv = [&](int i) {
        const int t0 = t_start + BK * i;
        float* Kst = ring + (i % FA_STAGES) * 2 * MT;
        fa_stage_rows<D, BK, NT>(Kst, kbase + (long long)t0 * k_st, k_st,
                                 T_len - t0, tid);
        fa_stage_rows<D, BK, NT>(Kst + MT, vbase + (long long)t0 * v_st,
                                 v_st, T_len - t0, tid);
    };
    load_kv(0);
    fa_cp_async_commit();

    // this thread's two rows, ra (fragment rows g) and rb (g + 8)
    const int ra = q0 + 16 * pr + g, rb = ra + 8;
    int lo_a, hi_a, lo_b, hi_b;
    fa_band(q_offset + ra, T_len, causal, window, lo_a, hi_a);
    fa_band(q_offset + rb, T_len, causal, window, lo_b, hi_b);

    float m_a = FA_NEG, m_b = FA_NEG, l_a = 0.0f, l_b = 0.0f;
    float acc[DH / 8][4];
    fa_zero(acc);
    const uint32_t q_row = fa_smem(Qs + 16 * pr * RS);
    float4* pex = ex + pr * (BK / 8) * 32;     // the pair's P
    float* prx = rx + pr * 32;                 // the pair's rows: [half][16]
    const int m0 = hf * (BK / 2);              // the warp's first key

    for (int i = 0; i < n_kt; ++i) {
        if (i + 1 < n_kt) load_kv(i + 1);
        fa_cp_async_commit();
        fa_cp_async_wait<1>();
        __syncthreads();
        const float* Kst = ring + (i % FA_STAGES) * 2 * MT;
        const float* Vst = Kst + MT;
        const int t0 = t_start + BK * i + m0;

        // S for the pair's 16 rows and the warp's BK/2 keys
        float sc[NW][4];
        fa_zero(sc);
        fa_qk_smem<D, NW>(sc, q_row, fa_smem(Kst + m0 * RS), lane);
        // scale, masks (a select: -1e30 for a masked key, -inf past T),
        // the row max of the warp's half over its quad
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int n = 0; n < NW; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = t0 + 8 * n + 2 * t + (e & 1);
                const bool vis = e < 2 ? key >= lo_a && key < hi_a
                                       : key >= lo_b && key < hi_b;
                const float s = vis ? fa_softcap<CAP>(sc[n][e] * scale, cap)
                                    : (key < T_len ? FA_NEG : -INFINITY);
                sc[n][e] = s;
                if (e < 2) mx_a = fmaxf(mx_a, s);
                else mx_b = fmaxf(mx_b, s);
            }
        }
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
        // the pair's common row max: each half's through shared memory
        if (t == 0) {
            prx[16 * hf + g] = mx_a;
            prx[16 * hf + g + 8] = mx_b;
        }
        fx_pair_sync(pr);
        mx_a = fmaxf(mx_a, prx[16 * (1 - hf) + g]);
        mx_b = fmaxf(mx_b, prx[16 * (1 - hf) + g + 8]);
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        float ps_a = 0.0f, ps_b = 0.0f;
#pragma unroll
        for (int n = 0; n < NW; ++n) {
            sc[n][0] = expf(sc[n][0] - mn_a);
            sc[n][1] = expf(sc[n][1] - mn_a);
            sc[n][2] = expf(sc[n][2] - mn_b);
            sc[n][3] = expf(sc[n][3] - mn_b);
            ps_a += sc[n][0] + sc[n][1];
            ps_b += sc[n][2] + sc[n][3];
        }
        const float corr_a = expf(m_a - mn_a), corr_b = expf(m_b - mn_b);
        l_a = l_a * corr_a + ps_a;
        l_b = l_b * corr_b + ps_b;
        m_a = mn_a;
        m_b = mn_b;
        fx_put<NW>(pex, sc, hf * NW, lane);
        fx_pair_sync(pr);
        float p[BK / 8][4];
        fx_get<BK / 8>(p, pex, lane);

        // O = O * corr + P.V over the warp's DH columns: the tile's
        // product summed from zero, then added in f32.  P is split once a
        // tile; it is the A operand with each 8-key slice's contraction
        // index permuted (slot t <-> 2t, t+4 <-> 2t+1), V's rows read in
        // the same order as two scalar words a B fragment (ldmatrix
        // cannot transpose 32-bit words), free of bank conflicts
        float part[DH / 8][4];
        fa_zero(part);
        const float* vcol = Vst + hf * DH + g;
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
            uint32_t ah[4], al[4];
            tf32_split(p[kk][0], ah[0], al[0]);    // (g,   slot t)
            tf32_split(p[kk][2], ah[1], al[1]);    // (g+8, slot t)
            tf32_split(p[kk][1], ah[2], al[2]);    // (g,   slot t+4)
            tf32_split(p[kk][3], ah[3], al[3]);    // (g+8, slot t+4)
            const float* bp = vcol + (8 * kk + 2 * t) * RS;
#pragma unroll
            for (int n = 0; n < DH / 8; ++n) {
                uint32_t bh0, bl0, bh1, bl1;
                tf32_split(bp[8 * n], bh0, bl0);
                tf32_split(bp[RS + 8 * n], bh1, bl1);
                mma3(part[n], ah, al, bh0, bh1, bl0, bl1);
            }
        }
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
            float (&o)[4] = acc[n];
            o[0] = o[0] * corr_a + part[n][0];
            o[1] = o[1] * corr_a + part[n][1];
            o[2] = o[2] * corr_b + part[n][2];
            o[3] = o[3] * corr_b + part[n][3];
        }
        __syncthreads();        // before the ring slot and exchanges reload
    }
    fa_cp_async_wait<0>();

    // l: the quad's partial sums, then the pair's two halves
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    if (t == 0) {
        prx[16 * hf + g] = l_a;
        prx[16 * hf + g + 8] = l_b;
    }
    fx_pair_sync(pr);
    l_a += prx[16 * (1 - hf) + g];
    l_b += prx[16 * (1 - hf) + g + 8];

    const float la = fmaxf(l_a, 1e-30f), lb = fmaxf(l_b, 1e-30f);
    const long long oa =
        (((long long)b * S + ra) * H + h) * D + hf * DH + 2 * t;
    const long long ob = oa + 8LL * H * D;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
        if (ra < S)
            *reinterpret_cast<float2*>(out + oa + 8 * n) =
                make_float2(acc[n][0] / la, acc[n][1] / la);
        if (rb < S)
            *reinterpret_cast<float2*>(out + ob + 8 * n) =
                make_float2(acc[n][2] / lb, acc[n][3] / lb);
    }
    if (LSE && (!CAP || lse != nullptr) && t == 0 && hf == 0) {
        const long long rs = ((long long)b * H + h) * S;
        if (ra < S) lse[rs + ra] = m_a + logf(la);
        if (rb < S) lse[rs + rb] = m_b + logf(lb);
    }
}

// One block: 64 q rows of one (b, h); the grid is 1-D, the last q tiles
// first (under a causal mask they see the most keys).
template <int D, bool LSE, bool CAP>
__global__ void __launch_bounds__(D <= 64 ? FA_THREADS : 2 * FA_THREADS,
                                  D <= 64 ? 2 : 1)
fa_fwd_f32_kernel(FA_FWD_PARAMS) {
    if constexpr (D <= 64)
        fa_fwd_narrow<D, LSE, CAP>(FA_FWD_PASS);
    else
        fa_fwd_wide<D, LSE, CAP>(FA_FWD_PASS);
}

template <int D, bool LSE, bool CAP>
static int launch_f32_as(const float* q, const float* k, const float* v,
                         float* out, float* lse, int B, int S, int T_len,
                         int H, int Hkv, const long long* st, int causal,
                         int window, int q_offset, float scale,
                         cudaStream_t stream, float cap) {
    const int smem = fa_smem_floats<D>() * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        fa_fwd_f32_kernel<D, LSE, CAP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (long long)((S + FA_BQ - 1) / FA_BQ) * H * B;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    fa_fwd_f32_kernel<D, LSE, CAP><<<(unsigned)blocks, fa_threads<D>(),
                                     smem, stream>>>(
        q, k, v, out, lse, S, T_len, H, Hkv, st[0], st[1], st[2], st[3],
        st[4], st[5], st[6], st[7], st[8], causal, window, q_offset, scale,
        cap);
    return (int)cudaGetLastError();
}

// 16-byte address and strides (in floats: multiples of 4) for cp.async
static bool fa_f32_aligned(const void* p, const long long* st) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0
           && st[0] % 4 == 0 && st[1] % 4 == 0 && st[2] % 4 == 0;
}

// CAP: with a softcap `cap` > 0 (flash_attention_softcap.cu's
// instantiations): the LSE kernel, lse written where it is not null
template <int D, bool CAP = false>
static int launch_f32(const void* q, const void* k, const void* v, void* out,
                      int B, int S, int T_len, int H, int Hkv,
                      const long long* st, int causal, int window,
                      int q_offset, float scale, cudaStream_t stream,
                      float* lse, float cap = 0.0f) {
    if (!fa_f32_aligned(k, st + 3) || !fa_f32_aligned(v, st + 6))
        return (int)cudaErrorInvalidValue;
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    float* of = static_cast<float*>(out);
    if constexpr (CAP) {
        return launch_f32_as<D, true, true>(qf, kf, vf, of, lse, B, S, T_len,
                                            H, Hkv, st, causal, window,
                                            q_offset, scale, stream, cap);
    } else {
        if (lse != nullptr)
            return launch_f32_as<D, true, false>(qf, kf, vf, of, lse, B, S,
                                                 T_len, H, Hkv, st, causal,
                                                 window, q_offset, scale,
                                                 stream, 0.0f);
        return launch_f32_as<D, false, false>(qf, kf, vf, of, nullptr, B, S,
                                              T_len, H, Hkv, st, causal,
                                              window, q_offset, scale, stream,
                                              0.0f);
    }
}


// ---------------------------------------------------------------------
// The bf16 kernel: tensor cores (wgmma), a TMA-fed K/V ring
// ---------------------------------------------------------------------

namespace tc {

constexpr int BQ = 128;          // q rows a CTA: two consumer warpgroups
constexpr int BK = 128;          // keys a K/V tile
constexpr int STAGES = 3;        // depth of the K/V ring
constexpr int THREADS = 384;     // producer warpgroup + 2 consumers
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr float NEG = -1e30f;

// Shared-memory layout of one head size.  A tile is stored in the
// swizzled column blocks of fa_hopper.cuh's Tiles<D> (one block up to D
// = 64, two and three 128-byte ones at D = 128 and 192, five 32-byte
// ones at D = 80).  Every block starts on a multiple of 1024
// bytes, the longest swizzle repeat.  KEYS and DEPTH are the K/V tile
// and the ring: BK keys in STAGES stages up to D = 64.  WIDE (D = 80,
// 128, 192): the output is staged in the q tile's space, and the O
// buffer's room goes to the ring: BK keys in 3 stages at D = 80 and 128,
// 96 keys in 2 at D = 192 (S, P's two parts and O within the consumers'
// 240 registers).
template <int D>
struct Layout : Tiles<D> {
    static constexpr bool WIDE = D > 64;
    static constexpr int KEYS = D <= 128 ? BK : 96;
    static constexpr int DEPTH = D == 192 ? 2 : WIDE ? 3 : STAGES;
    static constexpr int Q_BYTES = BQ * 2 * D;
    static constexpr int KV_BYTES = KEYS * 2 * D;
    static constexpr int O_PITCH = D + 8;              // bf16, staging
    static constexpr int Q_OFF = 0;
    static constexpr int K_OFF = Q_OFF + Q_BYTES;
    static constexpr int V_OFF = K_OFF + DEPTH * KV_BYTES;
    static constexpr int O_OFF = WIDE ? Q_OFF : V_OFF + DEPTH * KV_BYTES;
    static constexpr int BAR_OFF =
        WIDE ? V_OFF + DEPTH * KV_BYTES
                : O_OFF + ((BQ * O_PITCH * 2 + 1023) / 1024) * 1024;
    // q_full, then full_k, full_v, empty_k, empty_v of every stage
    static constexpr int BYTES = BAR_OFF + 8 * (1 + 4 * DEPTH);
    static constexpr int ALLOC = BYTES + 1024;         // room to align
    static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "tiles");
    static_assert(ALLOC <= 227 * 1024, "shared memory");
};

// O += P . V for 16 keys: one m64nDk16.  At D = 80, 128 and 192, V's
// tile is five swizzled blocks of 16 columns, or two or three of 64,
// KEYS rows each.
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_v) {
    if constexpr (D == 64) wgmma_m64n64k16_rs(o, a, desc_v);
    else if constexpr (D == 32) wgmma_m64n32k16_rs(o, a, desc_v);
    else if constexpr (D == 16) wgmma_m64n16k16_rs(o, a, desc_v);
    else {
        // V's column blocks lie KEYS rows apart: the MN-major
        // descriptor's leading byte offset
        constexpr uint64_t LBO = (Layout<D>::KEYS * Layout<D>::ROW) >> 4;
        const uint64_t d = (desc_v & ~(0x3FFFull << 16)) | (LBO << 16);
        if constexpr (D == 80) wgmma_m64n80k16_rs(o, a, d);
        else if constexpr (D == 128) wgmma_m64n128k16_rs(o, a, d);
        else wgmma_m64n192k16_rs(o, a, d);
    }
}

// One warpgroup's 64 rows against one tile of N/2 keys (128, or 96 at
// D = 192), after S = Q.K^T is
// in ``s``: scores to the log2 domain (scale * log2 e), the masks where
// the tile needs them, and the online-softmax update of (m, l); ``s``
// leaves holding p = 2^(s - m) and ``corr`` the factor that carries the
// output accumulator over to the new m.  CAP: every score is first
// soft-capped and taken to the log2 domain, cap_log2 * tanh(s * scale /
// cap) with cap_log2 = cap * log2 e, by fa_hopper.cuh's branch-free
// softcap_r (one ex2 and one rcp; k2 = 2 log2 e * scale / cap), on an
// interior tile too, so the max and each exponent read the capped
// score.  Accumulator element i of a
// thread sits at row (lane/4 + 8*((i/2)&1)) of its warp's 16 and column
// 8*(i/4) + 2*(lane%4) + (i&1) of the tile; a row lives in the 4
// threads of a quad.
template <bool MASK, int N, bool CAP = false>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             float scale_log2, int t0, int T,
                                             int row_pos, int causal,
                                             int window, float k2 = 0.f,
                                             float cap_log2 = 0.f) {
    const int lane = threadIdx.x & 31;
    const float cap_m2 = -2.0f * cap_log2;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const int r = (i >> 1) & 1;
        if (MASK) {
            const int key = t0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
            const int p = row_pos + 8 * r;
            const bool real = key < T;
            const bool vis = real && (!causal || key <= p)
                             && (window <= 0 || key > p - window);
            s[i] = vis ? (CAP ? fmaf(cap_m2, softcap_r(s[i], k2), cap_log2)
                              : s[i] * scale_log2)
                       : (real ? NEG : -INFINITY);
        } else if (CAP) {
            s[i] = fmaf(cap_m2, softcap_r(s[i], k2), cap_log2);
        }
        mx[r] = fmaxf(mx[r], s[i]);
    }
    float m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // unmasked scores are still raw: scale > 0 commutes with max
        m_new[r] = fmaxf(m[r], MASK || CAP ? mx[r] : mx[r] * scale_log2);
        corr[r] = ex2(m[r] - m_new[r]);
        m[r] = m_new[r];
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = MASK || CAP ? ex2(s[i] - m_new[r])
                           : ex2(fmaf(s[i], scale_log2, -m_new[r]));
        sum[r] += s[i];
    }
    // l stays a per-thread partial sum until the epilogue
    l[0] = l[0] * corr[0] + sum[0];
    l[1] = l[1] * corr[1] + sum[1];
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2],
                                        const float (&corr)[2]) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
}

// LSE: also write each row's log-sum-exp (natural units) to lse (B,H,S).
// CAP: the scores soft-capped (softmax_tile), k2 and cap_log2 read only
// there; a CAP kernel is built with LSE only, and writes lse and out_lo
// where they are not null.
template <int D, bool LSE, bool CAP>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          __nv_bfloat16* __restrict__ out, int S, int T,
                          int H, int Hkv, int causal, int window,
                          int q_offset, float scale_log2,
                          float* __restrict__ lse,
                          __nv_bfloat16* __restrict__ out_lo, float k2,
                          float cap_log2) {
    using L = Layout<D>;
    constexpr int BK = L::KEYS;          // the tile and ring of this D
    constexpr int STAGES = L::DEPTH;
    extern __shared__ __align__(16) uint8_t smem_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    const uint32_t s_base = smem_u32(smem);
    const uint32_t s_q = s_base + L::Q_OFF;
    const uint32_t bar = s_base + L::BAR_OFF;
    // barrier addresses: q_full, then per stage full_k, full_v,
    // empty_k, empty_v
    auto full_k = [&](int st) { return bar + 8 * (1 + st); };
    auto full_v = [&](int st) { return bar + 8 * (1 + STAGES + st); };
    auto empty_k = [&](int st) { return bar + 8 * (1 + 2 * STAGES + st); };
    auto empty_v = [&](int st) { return bar + 8 * (1 + 3 * STAGES + st); };

    // the heaviest q tiles (causal: the last) are scheduled first
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int hk = h / (H / Hkv);

    // The keys this CTA walks: the union of its rows' bands, or all T
    // when a row sees no key (the last row is the first to see none).
    const int p_first = q_offset + q0;
    const int p_last = q_offset + min(q0 + BQ, S) - 1;
    const bool cta_blind = window > 0 && p_last - window + 1 >= T;
    const int lo = cta_blind || window <= 0 ? 0 : max(0, p_first - window + 1);
    const int hi = cta_blind || !causal ? T : min(T, p_last + 1);
    const int tile_lo = (lo / BK) * BK;
    const int n_tiles = (hi - tile_lo + BK - 1) / BK;

    if (threadIdx.x == 0) {
        mbar_init(bar, 1);
        for (int st = 0; st < STAGES; ++st) {
            mbar_init(full_k(st), 1);
            mbar_init(full_v(st), 1);
            mbar_init(empty_k(st), 8);     // lane 0 of each consumer warp
            mbar_init(empty_v(st), 8);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 0) {
        // ---- producer: one thread keeps the ring full ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     :: "n"(PRODUCER_REGS));
        if (threadIdx.x == 0) {
            mbar_expect_tx(bar, L::Q_BYTES);
            // one box a block of COLS columns
            for (int c = 0; c < D / L::COLS; ++c)
                tma_load_4d(s_q + c * BQ * L::ROW, &tm_q, bar, c * L::COLS,
                            q0, h, b);
            for (int j = 0; j < n_tiles; ++j) {
                const int st = j % STAGES;
                const int ph = (j / STAGES) & 1;
                const int t0 = tile_lo + j * BK;
                mbar_wait(empty_k(st), ph ^ 1);
                mbar_expect_tx(full_k(st), L::KV_BYTES);
                for (int c = 0; c < D / L::COLS; ++c)
                    tma_load_4d(s_base + L::K_OFF + st * L::KV_BYTES
                                + c * BK * L::ROW, &tm_k, full_k(st),
                                c * L::COLS, t0, hk, b);
                mbar_wait(empty_v(st), ph ^ 1);
                mbar_expect_tx(full_v(st), L::KV_BYTES);
                for (int c = 0; c < D / L::COLS; ++c)
                    tma_load_4d(s_base + L::V_OFF + st * L::KV_BYTES
                                + c * BK * L::ROW, &tm_v, full_v(st),
                                c * L::COLS, t0, hk, b);
            }
        }
    } else {
        // ---- consumers: 64 q rows each ----
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                     :: "n"(CONSUMER_REGS));
        const int w = wg - 1;
        const int tid = threadIdx.x & 127;
        const int warp = tid >> 5, lane = tid & 31;
        const int r0 = q0 + 64 * w;                   // first row
        const int n_rows = min(64, S - r0);           // rows < S
        const int pa = q_offset + r0;
        const int pb = pa + 63;
        // this warpgroup's own band over its rows < S, and whether one
        // of them sees no key (then it takes every tile of the CTA)
        const int p_end = pa + n_rows - 1;
        const bool wg_blind = window > 0 && p_end - window + 1 >= T;
        const int w_lo = window > 0 ? max(0, pa - window + 1) : 0;
        const int w_hi = causal ? min(T, p_end + 1) : T;
        const int row_pos = pa + 16 * warp + (lane >> 2);

        float o[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
        float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, corr[2] = {1.f, 1.f};
        float s[BK / 2];
        // P of the tile before, as two bf16 parts (P ~ pf + pf_lo)
        uint32_t pf[BK / 16][4], pf_lo[BK / 16][4];

        const uint64_t desc_q = make_desc(s_q + w * 64 * L::ROW, 16,
                                          L::ATOM, L::SWIZZLE);
        // S = Q . K^T (64 x BK), K-major operands from the ring
        auto issue_qk = [&](int st) {
            const uint32_t s_k = s_base + L::K_OFF + st * L::KV_BYTES;
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
                wgmma_qk(
                    s, desc_q + (uint64_t)(L::kstep(kk, BQ) >> 4),
                    make_desc(s_k + L::kstep(kk, BK), 16, L::ATOM,
                              L::SWIZZLE),
                    kk > 0);
        };
        // O += P . V = P_hi . V + P_lo . V: the parts (bf16, registers)
        // are A operands, V (keys x D, D contiguous) one MN-major B
        // operand for both
        auto issue_pv = [&](int st) {
            const uint32_t s_v = s_base + L::V_OFF + st * L::KV_BYTES;
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                const uint64_t desc_v = make_desc(s_v + kk * 16 * L::ROW,
                                                  L::ATOM, L::ATOM,
                                                  L::SWIZZLE);
                wgmma_pv<D>(o, pf[kk], desc_v);
                wgmma_pv<D>(o, pf_lo[kk], desc_v);
            }
        };
        auto softmax = [&](int j) {
            const int t0 = tile_lo + j * BK;
            // a tile needs the masks unless every key is real and seen
            // by every one of the 64 rows
            const bool interior = t0 + BK <= T
                                  && (!causal || t0 + BK - 1 <= pa)
                                  && (window <= 0 || t0 >= pb - window + 1);
            if (interior)
                softmax_tile<false, BK / 2, CAP>(s, m, l, corr, scale_log2,
                                                 t0, T, row_pos, causal,
                                                 window, k2, cap_log2);
            else
                softmax_tile<true, BK / 2, CAP>(s, m, l, corr, scale_log2,
                                                t0, T, row_pos, causal,
                                                window, k2, cap_log2);
        };
        // P split into its two bf16 parts: the accumulator's layout is
        // the A fragment's
        auto pack_p = [&]() {
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    split_bf16(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1],
                               pf[kk][q], pf_lo[kk][q]);
        };
        // Ping-pong: the two warpgroups take turns to issue their
        // products (named barriers 3 and 4), so that one's softmax runs
        // while the other's products hold the tensor cores.  Each takes
        // n_tiles + 1 turns, warpgroup 0 first; every turn ends with an
        // arrival (a branch there made ptxas serialize the products),
        // and warpgroup 0 takes warpgroup 1's last one at the end.  CAP:
        // no turns; its softmax (3 SFU operations a score) outlasts the
        // other warpgroup's products, and the turns cost it 1-2.6 %
        // (tools/k4_variants.py: cap_turns)
        auto turn_begin = [&]() {
            if constexpr (!CAP)
                asm volatile("bar.sync %0, 256;\n" :: "r"(3 + w)
                             : "memory");
        };
        auto turn_end = [&]() {
            if constexpr (!CAP)
                asm volatile("bar.arrive %0, 256;\n" :: "r"(4 - w)
                             : "memory");
        };
        // a tile these rows do not see: released once it has landed (an
        // arrival for a later round of the stage must not count towards
        // this one, whose other warpgroup may still be reading)
        auto release = [&](int j) {
            const int st = j % STAGES, ph = (j / STAGES) & 1;
            mbar_wait(full_k(st), ph);
            mbar_wait(full_v(st), ph);
            if (lane == 0) {
                mbar_arrive(empty_k(st));
                mbar_arrive(empty_v(st));
            }
            turn_begin();
            turn_end();
        };
        // the tiles these rows see: a run [j_a, j_b) of the CTA's
        int j_a = n_tiles, j_b = n_tiles;
        if (n_rows > 0) {
            j_a = wg_blind ? 0 : max(0, (w_lo - tile_lo) / BK);
            j_b = wg_blind ? n_tiles
                           : min(n_tiles, (w_hi - tile_lo + BK - 1) / BK);
            if (j_b <= j_a) j_a = j_b = n_tiles;
        }

        if (!CAP && w == 1)
            asm volatile("bar.arrive 3, 256;\n" ::: "memory");
        mbar_wait(bar, 0);
        for (int j = 0; j < j_a; ++j) release(j);
        if (j_a < n_tiles) {
            {   // the first tile: its scores only
                const int st = j_a % STAGES, ph = (j_a / STAGES) & 1;
                mbar_wait(full_k(st), ph);
                turn_begin();
                wgmma_fence();
                issue_qk(st);
                wgmma_commit();
                turn_end();
                wgmma_wait<0>();
                fence_regs(s);
                if (lane == 0) mbar_arrive(empty_k(st));
                softmax(j_a);
                pack_p();
            }
            // tile j's scores and tile j-1's P.V in one turn; tile j's
            // softmax runs while that P.V is on the tensor cores
            for (int j = j_a + 1; j < j_b; ++j) {
                const int st = j % STAGES, ph = (j / STAGES) & 1;
                const int sp = (j - 1) % STAGES, pp = ((j - 1) / STAGES) & 1;
                mbar_wait(full_k(st), ph);
                mbar_wait(full_v(sp), pp);
                turn_begin();
                // o's rescale before the products: no register of an
                // issued product is written until its wait
                rescale<D>(o, corr);
                wgmma_fence();
                issue_qk(st);
                wgmma_commit();
                issue_pv(sp);
                wgmma_commit();
                turn_end();
                wgmma_wait<1>();
                fence_regs(s);
                if (lane == 0) mbar_arrive(empty_k(st));
                softmax(j);
                wgmma_wait<0>();
                fence_regs(o);
                if (lane == 0) mbar_arrive(empty_v(sp));
                pack_p();
            }
            {   // the last tile's P.V
                const int sp = (j_b - 1) % STAGES;
                const int pp = ((j_b - 1) / STAGES) & 1;
                mbar_wait(full_v(sp), pp);
                turn_begin();
                rescale<D>(o, corr);
                wgmma_fence();
                issue_pv(sp);
                wgmma_commit();
                turn_end();
                wgmma_wait<0>();
                fence_regs(o);
                if (lane == 0) mbar_arrive(empty_v(sp));
            }
        } else {
            turn_begin();          // the turn a run of tiles would add
            turn_end();
        }
        for (int j = j_b; j < n_tiles; ++j) release(j);
        if (!CAP && w == 0)
            asm volatile("bar.sync 3, 256;\n" ::: "memory");

        if (n_rows > 0) {
            // out = o / max(l, 1e-30), rounded once to bf16, staged in
            // shared memory and stored 16 bytes a thread, rows < S only
            float den[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
                l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
                den[r] = fmaxf(l[r], 1e-30f);
            }
            const int row = 16 * warp + (lane >> 2);
            if (LSE && (!CAP || lse != nullptr) && (lane & 3) == 0) {
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    if (row + 8 * r < n_rows)
                        lse[((long long)b * H + h) * S + r0 + row + 8 * r] =
                            m[r] <= NEG
                                ? NEG + logf(den[r])
                                : 0.6931471805599453f
                                      * (m[r] + log2f(den[r]));
                }
            }
            constexpr int CHUNKS = D / 8;             // 16 bytes each
            // out, then (LSE) out_lo, each staged in shared memory and
            // stored 16 bytes a thread, rows < S only
            const int parts = LSE && (!CAP || out_lo != nullptr) ? 2 : 1;
            for (int part = 0; part < parts; ++part) {
            __nv_bfloat16* dst = part ? out_lo : out;
            // two adjacent outputs: out, or what its rounding left
            auto value = [&](float a, float c) {
                const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
                return part ? __floats2bfloat162_rn(a - __low2float(hi),
                                                    c - __high2float(hi))
                            : hi;
            };
            if (part)          // every store of out has read the staging
                asm volatile("bar.sync %0, 128;\n" :: "r"(1 + w) : "memory");
            if constexpr (L::WIDE) {
                // staged in this warpgroup's own q rows (its last Q.K^T
                // has been waited on), in their swizzle (L::chunk: at
                // 128 bytes a row, 16-byte chunk k of row r at k ^ (r % 8))
                uint8_t* s_o = smem + L::Q_OFF + 64 * w * L::ROW;
#pragma unroll
                for (int i = 0; i < D / 2; i += 2) {
                    const int r = row + 8 * ((i >> 1) & 1);
                    const int col = 8 * (i >> 2) + 2 * (lane & 3);
                    *reinterpret_cast<__nv_bfloat162*>(
                        s_o + L::chunk(r, col / 8, BQ) + (col % 8) * 2) =
                        value(o[i] / den[(i >> 1) & 1],
                              o[i + 1] / den[(i >> 1) & 1]);
                }
                asm volatile("bar.sync %0, 128;\n" :: "r"(1 + w) : "memory");
                for (int c = tid; c < 64 * CHUNKS; c += 128) {
                    const int rr = c / CHUNKS, cc = c % CHUNKS;
                    if (rr < n_rows) {
                        const uint4 val = *reinterpret_cast<const uint4*>(
                            s_o + L::chunk(rr, cc, BQ));
                        *reinterpret_cast<uint4*>(
                            dst + (((long long)b * S + r0 + rr) * H + h) * D
                            + 8 * cc) = val;
                    }
                }
            } else {
            __nv_bfloat16* s_o = reinterpret_cast<__nv_bfloat16*>(
                smem + L::O_OFF) + 64 * w * L::O_PITCH;
#pragma unroll
            for (int i = 0; i < D / 2; i += 2) {
                const int r = (i >> 1) & 1;
                const int col = 8 * (i >> 2) + 2 * (lane & 3);
                *reinterpret_cast<__nv_bfloat162*>(
                    s_o + (row + 8 * r) * L::O_PITCH + col) =
                    value(o[i] / den[r], o[i + 1] / den[r]);
            }
            asm volatile("bar.sync %0, 128;\n" :: "r"(1 + w) : "memory");
            for (int c = tid; c < 64 * CHUNKS; c += 128) {
                const int rr = c / CHUNKS, cc = c % CHUNKS;
                if (rr < n_rows) {
                    const uint4 val = *reinterpret_cast<const uint4*>(
                        s_o + rr * L::O_PITCH + 8 * cc);
                    *reinterpret_cast<uint4*>(
                        dst + (((long long)b * S + r0 + rr) * H + h) * D
                        + 8 * cc) = val;
                }
            }
            }
            }
        }
    }
}

// ---- host side: tensor maps (fa_hopper.cuh) and the launches ----

template <int D, bool LSE, bool CAP>
static int launch_as(const void* q, const void* k, const void* v, void* out,
                     int B, int S, int T_len, int H, int Hkv,
                     const long long* st, int causal, int window,
                     int q_offset, float scale, cudaStream_t stream,
                     float* lse, void* out_lo, float softcap) {
    // element strides (batch, position, head) -> byte strides of the
    // (D, position, head, batch) maps
    CUtensorMap mq, mk, mv;
    constexpr int C = Layout<D>::COLS;
    const MapKey kq = {q, {D, S, H, B}, {2 * st[1], 2 * st[2], 2 * st[0]}, C,
                       BQ};
    const MapKey kk = {k, {D, T_len, Hkv, B},
                       {2 * st[4], 2 * st[5], 2 * st[3]}, C, Layout<D>::KEYS};
    const MapKey kv = {v, {D, T_len, Hkv, B},
                       {2 * st[7], 2 * st[8], 2 * st[6]}, C, Layout<D>::KEYS};
    int err = tensor_map(&mq, kq);
    if (err == 0) err = tensor_map(&mk, kk);
    if (err == 0) err = tensor_map(&mv, kv);
    if (err != 0) return err;
    const int smem = Layout<D>::ALLOC;
    cudaError_t ce = cudaFuncSetAttribute(
        flash_attention_tc_kernel<D, LSE, CAP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (ce != cudaSuccess) return (int)ce;
    const dim3 grid((S + BQ - 1) / BQ, H, B);
    flash_attention_tc_kernel<D, LSE, CAP><<<grid, THREADS, smem, stream>>>(
        mq, mk, mv, static_cast<__nv_bfloat16*>(out), S, T_len, H, Hkv,
        causal, window, q_offset,
        (float)((double)scale * 1.4426950408889634), lse,   // scale * log2 e
        static_cast<__nv_bfloat16*>(out_lo),
        softcap_k2(scale, CAP ? softcap : 0.0f),    // 2 log2 e scale / cap
        CAP ? (float)((double)softcap * 1.4426950408889634) : 0.0f);
    return (int)cudaGetLastError();
}

// CAP: with a softcap > 0 (flash_attention_softcap.cu's
// instantiations): the LSE kernel, lse and out_lo written where they
// are not null
template <int D, bool CAP = false>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int S, int T_len, int H, int Hkv,
                  const long long* st, int causal, int window, int q_offset,
                  float scale, cudaStream_t stream, float* lse,
                  void* out_lo, float softcap = 0.0f) {
    if constexpr (CAP) {
        return launch_as<D, true, true>(q, k, v, out, B, S, T_len, H, Hkv,
                                        st, causal, window, q_offset, scale,
                                        stream, lse, out_lo, softcap);
    } else {
        if (lse != nullptr)
            return launch_as<D, true, false>(q, k, v, out, B, S, T_len, H,
                                             Hkv, st, causal, window,
                                             q_offset, scale, stream, lse,
                                             out_lo, 0.0f);
        return launch_as<D, false, false>(q, k, v, out, B, S, T_len, H, Hkv,
                                          st, causal, window, q_offset, scale,
                                          stream, nullptr, nullptr, 0.0f);
    }
}

}  // namespace tc

// The kernels end here: flash_attention_softcap.cu includes this file
// with FA_KERNELS_ONLY defined, for the CAP instantiations alone.
#ifndef FA_KERNELS_ONLY

// The forwards with a logit softcap > 0 (with or without lse): defined
// in flash_attention_softcap.cu, linked into this library.
int fa_fwd_softcap(const void* q, const void* k, const void* v, void* out,
                   int dtype, int B, int S, int T_len, int H, int Hkv, int D,
                   const long long* st, int causal, int window, int q_offset,
                   float scale, cudaStream_t stream, float softcap,
                   float* lse, void* out_lo);

// q (B,S,H,D), k/v (B,T,Hkv,D) with element strides (batch, position,
// head) q_sb..v_sh and a unit stride on D (k and v of the f32 kernel on
// 16-byte addresses and strides, or it returns cudaErrorInvalidValue);
// out (B,S,H,D) contiguous.
// dtype 0 = f32 (split TF32), 1 = bf16 (the wgmma kernel), both on the
// tensor cores;
// all four tensors of that dtype.  D in {16, 32, 64, 80, 128, 192}: the
// models' 64, 80, 128 and 192 and the JAX kernel tests' 16 and 32.  lse:
// null, or (either dtype) a contiguous (B,H,S) f32 output for the rows'
// log-sum-exp m + log(max(l, 1e-30)) that the backward kernels
// (flash_attention_bwd.cu) read; asking for it changes no bit of out.
// out_lo: bf16 with lse, a contiguous (B,S,H,D) bf16 output for what
// the rounding of out left (out + out_lo is the f32 output to about
// 2^-16); null otherwise.
// softcap: 0, or a finite cap > 0 on the scores (cap * tanh(s / cap)
// before the masks), which takes the CAP instantiations of
// flash_attention_softcap.cu (lse then of the capped scores).
// Returns cudaGetLastError() after the launch (or the error that kept
// it from launching); does not synchronise.
extern "C" int flash_attention_fwd(
        const void* q, const void* k, const void* v, void* out, int dtype,
        int B, int S, int T_len, int H, int Hkv, int D,
        long long q_sb, long long q_ss, long long q_sh,
        long long k_sb, long long k_st, long long k_sh,
        long long v_sb, long long v_st, long long v_sh,
        int causal, int window, int q_offset, float scale, void* stream,
        void* lse, void* out_lo, float softcap) {
    if (B < 1 || S < 1 || T_len < 1 || H < 1 || Hkv < 1 || H % Hkv != 0
            || B > 65535 || H > 65535 || q_offset < 0
            || (out_lo != nullptr) != (dtype == 1 && lse != nullptr)
            || !(softcap >= 0.0f) || isinf(softcap))
        return (int)cudaErrorInvalidValue;
    const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_st, k_sh,
                             v_sb, v_st, v_sh};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* lse_f = static_cast<float*>(lse);
    if (softcap > 0.0f)
        return fa_fwd_softcap(q, k, v, out, dtype, B, S, T_len, H, Hkv, D,
                              st, causal, window, q_offset, scale, s,
                              softcap, lse_f, out_lo);
#define FA_ARGS q, k, v, out, B, S, T_len, H, Hkv, st, causal, window, \
                q_offset, scale, s
    if (dtype == 0) {
        switch (D) {
            case 16: return launch_f32<16>(FA_ARGS, lse_f);
            case 32: return launch_f32<32>(FA_ARGS, lse_f);
            case 64: return launch_f32<64>(FA_ARGS, lse_f);
            case 80: return launch_f32<80>(FA_ARGS, lse_f);
            case 128: return launch_f32<128>(FA_ARGS, lse_f);
            case 192: return launch_f32<192>(FA_ARGS, lse_f);
        }
    } else if (dtype == 1) {
        switch (D) {
            case 16: return tc::launch<16>(FA_ARGS, lse_f, out_lo);
            case 32: return tc::launch<32>(FA_ARGS, lse_f, out_lo);
            case 64: return tc::launch<64>(FA_ARGS, lse_f, out_lo);
            case 80: return tc::launch<80>(FA_ARGS, lse_f, out_lo);
            case 128: return tc::launch<128>(FA_ARGS, lse_f, out_lo);
            case 192: return tc::launch<192>(FA_ARGS, lse_f, out_lo);
        }
    }
#undef FA_ARGS
    return (int)cudaErrorInvalidValue;
}

template <int D>
static long long fa_sizes(int dtype, int which) {
    using L = tc::Layout<D>;
    const bool f32 = dtype == 0;
    switch (which) {
        case 0: return f32 ? fa_threads<D>() / 32 : tc::THREADS / 32;
        case 1: return f32 ? 4LL * fa_smem_floats<D>() : L::ALLOC;
        case 2: return f32 ? fa_keys<D>() : L::KEYS;
        case 3: return f32 ? FA_STAGES : L::DEPTH;
        case 4: return f32 ? 2 : 3;
        default: return -1;
    }
}

// The launch of one forward kernel at head dim D (dtype 0: the f32
// kernel, 1: the bf16 one): which = 0, warps a block; 1, bytes of
// dynamic shared memory; 2, keys a K/V tile; 3, stages of its ring; 4,
// the D-long dots it computes a visible (q, k) pair (bf16: Q.K^T and
// P.V with P in two bf16 parts).  Both kernels launch one block a (q
// tile, head, batch).  -1 for a D, dtype or which it does not have.
extern "C" long long flash_attention_fwd_sizes(int D, int dtype,
                                               int which) {
    if (dtype != 0 && dtype != 1) return -1;
    switch (D) {
        case 16: return fa_sizes<16>(dtype, which);
        case 32: return fa_sizes<32>(dtype, which);
        case 64: return fa_sizes<64>(dtype, which);
        case 80: return fa_sizes<80>(dtype, which);
        case 128: return fa_sizes<128>(dtype, which);
        case 192: return fa_sizes<192>(dtype, which);
    }
    return -1;
}

#endif  // FA_KERNELS_ONLY
