// The split products of K4's f32 kernels, shared by the forward
// (flash_attention.cu) and the backward pair (flash_attention_bwd.cu),
// so that the pair recomputes S exactly as the forward that summed its
// lse formed it (score_step, score_fold: the score products' sums).
// Each operand comes split into two TF32 values (tf32_split.cuh); a . b
// is taken as lo.hi + hi.lo + hi.hi on the tensor cores (m16n8k8, f32
// accumulators), the TF32 products exact in f32.

#pragma once

#include <stdint.h>

__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in split TF32: the two correction terms, then hi . hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
    mma_tf32(d, al, bh0, bh1);
    mma_tf32(d, ah, bl0, bl1);
    mma_tf32(d, ah, bh0, bh1);
}

// d += a . b as mma3, the three products summed from zero on the tensor
// cores and added to d in f32: the score products (the forward's S, the
// pair's S and dP).  The tensor cores round each sum of a chained
// product toward zero at the running sum's magnitude, which on scores of
// large terms left the output up to 3.7x as far from an f64 answer as
// the f32 twin at llama's serving layer, where a k-step's sum from zero
// and one f32 add (rounded to nearest) leave it at 0.5-0.85x
// (tools/k4_bwd_variants.py: chained; PERF.md)
__device__ __forceinline__ void mma3_from_zero(float (&d)[4],
                                               const uint32_t (&ah)[4],
                                               const uint32_t (&al)[4],
                                               uint32_t bh0, uint32_t bh1,
                                               uint32_t bl0, uint32_t bl1) {
    float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma3(t, ah, al, bh0, bh1, bl0, bl1);
    d[0] += t[0];
    d[1] += t[1];
    d[2] += t[2];
    d[3] += t[3];
}

// One 16-wide step of a score product (S, or the pair's dP) for one
// 8-key slice: the k-steps k0 (A in a0h / a0l, B words 0-1) and k0 + 8
// (a1h / a1l, words 2-3), each summed from zero.  Above D = 64 the odd
// k-steps go into a second accumulator, added to the first after the
// last step (score_fold): each running sum then takes half of the D/8
// f32 adds at about 0.7x the magnitude, which halves their rounding.  At
// D = 192 the 24 adds into one sum left the forward on q x 100 (cap 50)
// 2.98x its f32 twin's max abs distance from an f64 answer on one case
// of chip_smoke.py's softcap_checks, the two sums 1.37x
// (tools/k4_bwd_variants.py --scaled: v0 against one_sum; PERF.md); up
// to D = 64 (at most 8 adds) one sum is kept.
template <int D>
__device__ __forceinline__ void score_step(float (&even)[4], float (&odd)[4],
                                           const uint32_t (&a0h)[4],
                                           const uint32_t (&a0l)[4],
                                           const uint32_t (&a1h)[4],
                                           const uint32_t (&a1l)[4],
                                           const uint32_t (&bh)[4],
                                           const uint32_t (&bl)[4]) {
    mma3_from_zero(even, a0h, a0l, bh[0], bh[1], bl[0], bl[1]);
    if constexpr (D > 64)
        mma3_from_zero(odd, a1h, a1l, bh[2], bh[3], bl[2], bl[3]);
    else
        mma3_from_zero(even, a1h, a1l, bh[2], bh[3], bl[2], bl[3]);
}

// acc += odd above D = 64: the score product's two sums, after its last
// k-step (score_step)
template <int D, int N>
__device__ __forceinline__ void score_fold(float (&acc)[N][4],
                                           const float (&odd)[N][4]) {
    if constexpr (D > 64) {
#pragma unroll
        for (int n = 0; n < N; ++n) {
            acc[n][0] += odd[n][0];
            acc[n][1] += odd[n][1];
            acc[n][2] += odd[n][2];
            acc[n][3] += odd[n][3];
        }
    }
}
