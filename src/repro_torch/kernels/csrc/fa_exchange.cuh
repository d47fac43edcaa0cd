// The pair exchange of the split-TF32 kernels at head dims 128 and 192
// (flash_attention.cu's f32 forward, flash_attention_bwd.cu's dq and
// dkdv): the two warps of a pair share 16 rows, each computes a C
// fragment over half of a tile's columns, and each reads the whole
// fragment back.  A lane's four values of one 8-column slice go to one
// float4, so a lane reads back the same fragment slots of the other half
// (the permuted contraction that follows needs no shuffle), and the
// stores and loads are 16 bytes a lane, free of bank conflicts.
#pragma once

// the barrier of the two warps (64 threads) that share 16 rows: named
// barrier 1 + pair (0 is __syncthreads)
__device__ __forceinline__ void fx_pair_sync(int pair) {
    asm volatile("bar.sync %0, 64;\n" :: "r"(1 + pair) : "memory");
}

// the warp's N 8-column slices of a C fragment into the exchange from
// slice j0 on: a float4 a lane and slice
template <int N>
__device__ __forceinline__ void fx_put(float4* ex, const float (&c)[N][4],
                                       int j0, int lane) {
#pragma unroll
    for (int j = 0; j < N; ++j)
        ex[(j0 + j) * 32 + lane] =
            make_float4(c[j][0], c[j][1], c[j][2], c[j][3]);
}

// all K slices back, in the same fragment slots
template <int K>
__device__ __forceinline__ void fx_get(float (&c)[K][4], const float4* ex,
                                       int lane) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
        const float4 x = ex[j * 32 + lane];
        c[j][0] = x.x;
        c[j][1] = x.y;
        c[j][2] = x.z;
        c[j][3] = x.w;
    }
}
