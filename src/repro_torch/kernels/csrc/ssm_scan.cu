// Diagonal selective-SSM scan for Hopper (sm_90a).
//
//   per batch b, channel d, state n (A = -exp(a_log[d][n])):
//     h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t      (f32)
//     y_t = <h_t, C_t> = sum_n h_t[n] * C_t[n]
//   x, dt (B,S,D) and B_in, C_out (B,S,N) in f32 or bf16, any strides
//   (the model passes B_in and C_out as the two halves of one (B,S,2N)
//   tensor, strided views, no copies); a_log (D,N) f32; the starting
//   state h0 (B,D,N) f32 or null (zeros); y (B,S,D) contiguous in x's
//   type; h_end (B,D,N) f32 is the state after the last step, so a
//   prefill hands its state to decode and a decode step (S = 1) is one
//   launch with the carried state.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py: _kernel /
// ssm_scan, which keeps a (block_d, N) state block in VMEM across a
// sequential grid axis of time chunks; it also serves the reference
// model's chunked associative scan (src/repro/models/ssm.py: ssm_core,
// h0 in, h_end out).  Here every (b, d) channel is N lanes of a warp,
// one state each, held in a register for the whole sequence, and the
// block steps time sequentially; y_t is an N-lane __shfl_xor sum.  A
// block is 256 threads = 256/N channels of one batch row; it stages a
// chunk of 32 time steps of its channels' x and dt and of the row's
// B_t, C_t in shared memory (one coalesced pass), steps through it,
// and writes the chunk's y back in one pass.  The grid is
// ceil(D*N/256) x B blocks: B*D*N/32 warps, 102,400 threads at the
// serving path's prefill (B=2, D=3200, N=16) where one thread per
// channel would be 6,400.
//
// Bound: bytes at the path's shapes -- x and dt read once, y written
// once, B/C read once per row (the exp per state element, B*S*D*N of
// them, is the operations side).  The recurrence is a serial chain per
// channel over S, so the kernel is latency-bound well before either:
// that is what a later, chunked-parallel version has to attack.  expf,
// no fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define SS_THREADS 256
#define SS_TC 32          // time steps staged per chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_as(float v, __nv_bfloat16* p) {
    *p = __float2bfloat16_rn(v);
}

struct SsStrides {
    long long x_b, x_s, x_d, dt_b, dt_s, dt_d;
    long long b_b, b_s, b_n, c_b, c_s, c_n;
};

template <typename T, int N>
__global__ void __launch_bounds__(SS_THREADS)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const T* __restrict__ bm, const T* __restrict__ cm,
                const float* __restrict__ a_log,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ h_end, int S, int D, SsStrides st) {
    constexpr int CH = SS_THREADS / N;   // channels of this block
    __shared__ float xs[SS_TC][CH], dts[SS_TC][CH], ys[SS_TC][CH];
    __shared__ float bs[SS_TC][N], cs[SS_TC][N];

    const int b = blockIdx.y;
    const int d0 = blockIdx.x * CH;
    const int ch = threadIdx.x / N;
    const int n = threadIdx.x % N;
    const int d = d0 + ch;
    const bool ok = d < D;
    const float a_neg = ok ? -expf(a_log[(long long)d * N + n]) : 0.0f;
    float h = (ok && h0) ? h0[((long long)b * D + d) * N + n] : 0.0f;

    for (int t0 = 0; t0 < S; t0 += SS_TC) {
        const int tc = min(SS_TC, S - t0);
        for (int i = threadIdx.x; i < SS_TC * CH; i += SS_THREADS) {
            const int tt = i / CH, cc = i % CH, dd = d0 + cc;
            float xv = 0.0f, dv = 0.0f;
            if (tt < tc && dd < D) {
                const long long t = t0 + tt;
                xv = to_f32(x[b * st.x_b + t * st.x_s + dd * st.x_d]);
                dv = to_f32(dt[b * st.dt_b + t * st.dt_s + dd * st.dt_d]);
            }
            xs[tt][cc] = xv;
            dts[tt][cc] = dv;
        }
        for (int i = threadIdx.x; i < SS_TC * N; i += SS_THREADS) {
            const int tt = i / N, nn = i % N;
            float bv = 0.0f, cv = 0.0f;
            if (tt < tc) {
                const long long t = t0 + tt;
                bv = to_f32(bm[b * st.b_b + t * st.b_s + nn * st.b_n]);
                cv = to_f32(cm[b * st.c_b + t * st.c_s + nn * st.c_n]);
            }
            bs[tt][nn] = bv;
            cs[tt][nn] = cv;
        }
        __syncthreads();

#pragma unroll 4
        for (int tt = 0; tt < tc; ++tt) {
            const float dtv = dts[tt][ch];
            const float da = expf(dtv * a_neg);
            h = da * h + (dtv * xs[tt][ch]) * bs[tt][n];
            float part = h * cs[tt][n];
#pragma unroll
            for (int off = N / 2; off > 0; off >>= 1)
                part += __shfl_xor_sync(0xffffffffu, part, off);
            if (n == 0) ys[tt][ch] = part;
        }
        __syncthreads();

        for (int i = threadIdx.x; i < SS_TC * CH; i += SS_THREADS) {
            const int tt = i / CH, cc = i % CH, dd = d0 + cc;
            if (tt < tc && dd < D)
                store_as(ys[tt][cc],
                         y + ((long long)b * S + t0 + tt) * D + dd);
        }
        // the next chunk's staging writes xs/dts/bs/cs only; ys is
        // written again after the next __syncthreads
    }
    if (ok) h_end[((long long)b * D + d) * N + n] = h;
}

template <typename T, int N>
static int launch_ss(const void* x, const void* dt, const void* bm,
                     const void* cm, const float* a_log, const float* h0,
                     void* y, float* h_end, int B, int S, int D,
                     const SsStrides& st, cudaStream_t stream) {
    constexpr int CH = SS_THREADS / N;
    const dim3 grid((D + CH - 1) / CH, B);
    ssm_scan_kernel<T, N><<<grid, SS_THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dt),
        static_cast<const T*>(bm), static_cast<const T*>(cm), a_log, h0,
        static_cast<T*>(y), h_end, S, D, st);
    return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_n(const void* x, const void* dt, const void* bm,
                      const void* cm, const float* a_log, const float* h0,
                      void* y, float* h_end, int B, int S, int D, int N,
                      const SsStrides& st, cudaStream_t s) {
    switch (N) {
        case 4: return launch_ss<T, 4>(x, dt, bm, cm, a_log, h0, y, h_end,
                                       B, S, D, st, s);
        case 8: return launch_ss<T, 8>(x, dt, bm, cm, a_log, h0, y, h_end,
                                       B, S, D, st, s);
        case 16: return launch_ss<T, 16>(x, dt, bm, cm, a_log, h0, y,
                                         h_end, B, S, D, st, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// x, dt (B,S,D) and b_in, c_out (B,S,N) with element strides (batch,
// time, channel/state); a_log (D,N) f32 contiguous; h0 (B,D,N) f32
// contiguous or null; y (B,S,D) contiguous; h_end (B,D,N) f32
// contiguous.  dtype 0 = f32, 1 = bf16 (x, dt, b_in, c_out and y);
// N in {4, 8, 16}.  Returns cudaGetLastError() after the launch;
// does not synchronise.
extern "C" int ssm_scan_fwd(
        const void* x, const void* dt, const void* b_in, const void* c_out,
        const void* a_log, const void* h0, void* y, void* h_end, int dtype,
        int B, int S, int D, int N,
        long long x_sb, long long x_ss, long long x_sd,
        long long dt_sb, long long dt_ss, long long dt_sd,
        long long b_sb, long long b_ss, long long b_sn,
        long long c_sb, long long c_ss, long long c_sn, void* stream) {
    if (B < 1 || B > 65535 || S < 1 || D < 1)
        return (int)cudaErrorInvalidValue;
    const SsStrides st{x_sb, x_ss, x_sd, dt_sb, dt_ss, dt_sd,
                       b_sb, b_ss, b_sn, c_sb, c_ss, c_sn};
    const float* al = static_cast<const float*>(a_log);
    const float* hp = static_cast<const float*>(h0);
    float* he = static_cast<float*>(h_end);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return dispatch_n<float>(x, dt, b_in, c_out, al, hp, y, he,
                                         B, S, D, N, st, s);
        case 1: return dispatch_n<__nv_bfloat16>(x, dt, b_in, c_out, al, hp,
                                                 y, he, B, S, D, N, st, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
