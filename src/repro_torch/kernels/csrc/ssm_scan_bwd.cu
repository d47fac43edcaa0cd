// The f32 backward of K5, the diagonal selective scan of ssm_scan.cu,
// for Hopper (sm_90a): one kernel, reverse time.
//
// The JAX package has no backward Pallas kernel: JAX differentiates the
// reference model's jnp scan, and its training never calls
// src/repro/kernels/ssm_scan.py: _kernel.  The port routes every CUDA
// tensor to its forward kernel, so a gradient through that kernel needs
// this one.  The bf16 backward is a later item (ROADMAP, queue 2).
//
//   forward, per batch b, channel d, state n (A = -exp(a_log[d][n])):
//     a_t = exp(dt_t * A),  h_t = a_t * h_{t-1} + (dt_t * x_t) * B_t[n],
//     y_t = sum_n h_t[n] * C_t[n],  h_{-1} = h0,  h_end = h_{S-1}
//   backward, with g_t = dL/dh_t (reverse time; g_{S-1} seeded with the
//   incoming gradient of h_end):
//     g_t      = C_t * dy_t + a_{t+1} * g_{t+1}
//     dx_t     = dt_t * sum_n g_t B_t
//     ddt_t    = sum_n g_t * (x_t B_t + A a_t h_{t-1})
//     dB_t[n]  = sum_d g_t dt_t x_t,      dC_t[n] = sum_d h_t dy_t
//     dA_log   = A * sum_{b,t} g_t h_{t-1} a_t dt_t
//     dh0      = a_0 * g_0
//
//   x, dt (B,S,D) and B_in, C_out (B,S,N) f32 with any strides (the
//   model's strided halves of one (B,S,2N) tensor); a_log (D,N), h0
//   (B,D,N) or null, dy (B,S,D), dh_end (B,D,N) or null, contiguous f32.
//   Out, contiguous f32: dx, ddt (B,S,D); dbc (B,G,S,2N) -- per channel
//   group of 32, dB then dC, the wrapper sums the G axis; da (B,D,N) --
//   per batch row, the wrapper sums the B axis; dh0 (B,D,N).  No float
//   atomics: every cross-block sum is a partial the wrapper adds up in a
//   fixed order, so a gradient is the same bits every run.
//
// Design: one block is one warp, one (batch row, group of 32 channels),
// a lane a channel with its N states in registers (the forward's
// layout).  The states h_t are never stored for every t -- (B,S,D,N) f32
// is 420 MB a layer at hymba's B=2, S=1024 -- only every SB_L steps:
//   * pass 1 runs the recurrence forward from h0 and stores the state at
//     the start of each chunk of SB_L steps in ``hck`` (B, chunks, D, N),
//     scratch the wrapper allocates;
//   * pass 2 walks the chunks from the last to the first: it stages the
//     chunk's x, dt, dy and B|C in shared memory, replays the chunk from
//     its stored state keeping every h_t of it in shared memory, then
//     runs the chunk's steps in reverse carrying g in registers.
// A step's dB and dC (2N sums over the warp's 32 channels) are one
// reduce-scatter of 31 shuffles for N=16 (each lane ends with one of
// the 2N sums), written as the block's partial.  The forward kernel's
// arithmetic is replayed exactly (ex2.approx of dt * A * log2(e), the
// same fmaf order), so the states are the forward's.
//
// Bound: the B*S*D*N exps of a_t (this design takes three: pass 1, the
// replay, the reverse step) and the bytes (x, dt, dy, B, C read, dx, ddt
// written, the partials); one warp a block leaves each SM one or two
// warps at hymba's B=1, D=3200 (100 blocks): latency, not the SFU,
// binds it.  A time-parallel design, as the forward's, is later work.

#include <cuda_runtime.h>
#include <math.h>

constexpr int SB_L = 32;           // steps a chunk (the replay window)
constexpr int SB_CH = 32;          // channels a block: one a lane
constexpr float SB_LOG2E = 1.4426950408889634f;

struct SbStrides {
    long long x_b, x_s, x_d, dt_b, dt_s, dt_d;
    long long b_b, b_s, b_n, c_b, c_s, c_n;
};

__device__ __forceinline__ float sb_ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// Shared memory of one block, in floats.
template <int N>
struct SbSmem {
    static constexpr int X = 0;                        // [L][32]
    static constexpr int DT = X + SB_L * SB_CH;        // [L][32]
    static constexpr int DY = DT + SB_L * SB_CH;       // [L][32]
    static constexpr int BC = DY + SB_L * SB_CH;       // [L][2N]
    static constexpr int H = BC + SB_L * 2 * N;        // [L+1][N][32]
    static constexpr int FLOATS = H + (SB_L + 1) * N * SB_CH;
    static constexpr int BYTES = FLOATS * 4;
};

// Sum over the warp's 32 lanes of each of V values a lane holds (V a
// power of two <= 32), scattered: recursive halving, each lane ends
// with the sum of value lane / (32 / V).
template <int V>
__device__ __forceinline__ float sb_reduce_scatter(float (&v)[V], int lane) {
#pragma unroll
    for (int lvl = 0; lvl < 5; ++lvl) {
        const int o = 16 >> lvl;
        const int cnt = V >> lvl;          // values still held (unrolled:
        if (cnt >= 2) {                    // a constant each level)
            const int half = cnt / 2;
            const bool up = (lane & o) != 0;
#pragma unroll
            for (int i = 0; i < V / 2; ++i) {
                if (i < half) {
                    const float send = up ? v[i] : v[i + half];
                    const float keep = up ? v[i + half] : v[i];
                    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
                }
            }
        } else {
            v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
        }
    }
    return v[0];
}

template <int N>
__global__ void __launch_bounds__(SB_CH)
ssm_scan_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ bm, const float* __restrict__ cm,
                    const float* __restrict__ a_log,
                    const float* __restrict__ h0,
                    const float* __restrict__ dy,
                    const float* __restrict__ dh_end,
                    float* __restrict__ dx, float* __restrict__ ddt,
                    float* __restrict__ dbc, float* __restrict__ da,
                    float* __restrict__ dh0, float* __restrict__ hck,
                    int S, int D, SbStrides st) {
    using SM = SbSmem<N>;
    constexpr int V = 2 * N;
    extern __shared__ __align__(16) float sb_smem[];
    float* xs = sb_smem + SM::X;
    float* ds = sb_smem + SM::DT;
    float* dys = sb_smem + SM::DY;
    float* bcs = sb_smem + SM::BC;
    float* hs = sb_smem + SM::H;

    const int lane = threadIdx.x;
    const int g = blockIdx.x;
    const int b = blockIdx.y;
    const int groups = gridDim.x;
    const int d = g * SB_CH + lane;
    const bool ok = d < D;
    const int dd = ok ? d : 0;
    const int chunks = (S + SB_L - 1) / SB_L;

    float A[N], a2[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
        A[n] = ok ? -expf(a_log[(long long)d * N + n]) : 0.0f;
        a2[n] = A[n] * SB_LOG2E;
    }
    const float* xp = x + b * st.x_b + dd * st.x_d;
    const float* dtp = dt + b * st.dt_b + dd * st.dt_d;
    const float* dyp = dy + (long long)b * S * D + dd;
    const long long hrow = ((long long)b * D + dd) * N;

    // stage steps [t0, t0 + len) of the chunk; steps past len are zeros
    auto stage = [&](int t0, int len, bool with_dy) {
        __syncwarp();                       // the last chunk's reads done
#pragma unroll 8
        for (int i = 0; i < SB_L; ++i) {
            const bool in = ok && i < len;
            const long long t = t0 + i;
            xs[i * SB_CH + lane] = in ? xp[t * st.x_s] : 0.0f;
            ds[i * SB_CH + lane] = in ? dtp[t * st.dt_s] : 0.0f;
            if (with_dy) dys[i * SB_CH + lane] = in ? dyp[t * D] : 0.0f;
        }
        for (int e = lane; e < SB_L * V; e += SB_CH) {
            const int i = e / V, q = e % V;
            const long long t = t0 + i;
            float val = 0.0f;
            if (i < len)
                val = q < N ? bm[b * st.b_b + t * st.b_s + q * st.b_n]
                            : cm[b * st.c_b + t * st.c_s + (q - N) * st.c_n];
            bcs[e] = val;
        }
        __syncwarp();
    };
    // advance h over steps [0, len) of the staged chunk; with ``keep``
    // the state after step i goes to hs[i + 1]
    auto run = [&](int len, float (&h)[N], bool keep) {
        for (int i = 0; i < len; ++i) {
            const float dv = ds[i * SB_CH + lane];
            const float dxv = dv * xs[i * SB_CH + lane];
            const float* row = bcs + i * V;
#pragma unroll
            for (int n = 0; n < N; ++n) {
                h[n] = fmaf(sb_ex2(dv * a2[n]), h[n], dxv * row[n]);
                if (keep) hs[((i + 1) * N + n) * SB_CH + lane] = h[n];
            }
        }
    };

    // pass 1: the state at the start of every chunk
    float h[N];
#pragma unroll
    for (int n = 0; n < N; ++n) h[n] = (ok && h0) ? h0[hrow + n] : 0.0f;
    for (int ck = 0; ck < chunks; ++ck) {
        float* slot = hck + (((long long)b * chunks + ck) * D + dd) * N;
        if (ok) {
#pragma unroll
            for (int n = 0; n < N; ++n) slot[n] = h[n];
        }
        if (ck + 1 < chunks) {
            const int t0 = ck * SB_L;
            stage(t0, min(SB_L, S - t0), false);
            run(min(SB_L, S - t0), h, false);
        }
    }

    // pass 2: chunks last to first, each replayed, then walked back
    float gr[N], dacc[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
        gr[n] = (ok && dh_end) ? dh_end[hrow + n] : 0.0f;
        dacc[n] = 0.0f;
    }
    const int q_mine = lane / (SB_CH / V);
    const bool writer = lane % (SB_CH / V) == 0;
    for (int ck = chunks - 1; ck >= 0; --ck) {
        const int t0 = ck * SB_L;
        const int len = min(SB_L, S - t0);
        stage(t0, len, true);
        const float* slot = hck + (((long long)b * chunks + ck) * D + dd) * N;
#pragma unroll
        for (int n = 0; n < N; ++n) {
            h[n] = ok ? __ldcg(slot + n) : 0.0f;
            hs[n * SB_CH + lane] = h[n];
        }
        run(len, h, true);
        for (int i = len - 1; i >= 0; --i) {
            const long long t = t0 + i;
            const float dv = ds[i * SB_CH + lane];
            const float xv = xs[i * SB_CH + lane];
            const float dyv = dys[i * SB_CH + lane];
            const float dtx = dv * xv;
            const float* row = bcs + i * V;
            float vals[V];
            float sx = 0.0f, sdt = 0.0f;
#pragma unroll
            for (int n = 0; n < N; ++n) {
                const float hc = hs[((i + 1) * N + n) * SB_CH + lane];
                const float hp = hs[(i * N + n) * SB_CH + lane];
                const float a = sb_ex2(dv * a2[n]);
                const float bn = row[n];
                gr[n] = fmaf(row[N + n], dyv, gr[n]);
                vals[n] = gr[n] * dtx;
                vals[N + n] = hc * dyv;
                sx = fmaf(gr[n], bn, sx);
                const float ha = (hp * A[n]) * a;
                sdt = fmaf(gr[n], fmaf(xv, bn, ha), sdt);
                dacc[n] = fmaf(gr[n], (hp * a) * dv, dacc[n]);
                gr[n] *= a;
            }
            if (ok) {
                dx[((long long)b * S + t) * D + d] = dv * sx;
                ddt[((long long)b * S + t) * D + d] = sdt;
            }
            const float part = sb_reduce_scatter<V>(vals, lane);
            if (writer)
                dbc[(((long long)b * groups + g) * S + t) * V + q_mine] = part;
        }
    }
    if (ok) {
#pragma unroll
        for (int n = 0; n < N; ++n) {
            dh0[hrow + n] = gr[n];
            da[hrow + n] = A[n] * dacc[n];
        }
    }
}

template <int N>
static int launch_sb(const float* x, const float* dt, const float* bm,
                     const float* cm, const float* a_log, const float* h0,
                     const float* dy, const float* dh_end, float* dx,
                     float* ddt, float* dbc, float* da, float* dh0,
                     float* hck, int B, int S, int D, const SbStrides& st,
                     cudaStream_t stream) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssm_scan_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SbSmem<N>::BYTES);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((D + SB_CH - 1) / SB_CH, B);
    ssm_scan_bwd_kernel<N><<<grid, SB_CH, SbSmem<N>::BYTES, stream>>>(
        x, dt, bm, cm, a_log, h0, dy, dh_end, dx, ddt, dbc, da, dh0, hck, S,
        D, st);
    return (int)cudaGetLastError();
}

// Sizes of one call's buffers, in floats: which = 0, the chunk states
// ``hck`` (scratch); 1, the groups G of the dB|dC partial (B,G,S,2N).
extern "C" long long ssm_scan_bwd_sizes(int B, int S, int D, int N,
                                        int which) {
    if (B < 1 || S < 1 || D < 1 || N < 1) return 0;
    const long long chunks = (S + SB_L - 1) / SB_L;
    switch (which) {
        case 0: return (long long)B * chunks * D * N;
        case 1: return (D + SB_CH - 1) / SB_CH;
        default: return -1;
    }
}

// x, dt (B,S,D), b_in, c_out (B,S,N) f32 with element strides (batch,
// time, channel/state); a_log (D,N), h0 (B,D,N) or null, dy (B,S,D),
// dh_end (B,D,N) or null: contiguous f32.  dx, ddt (B,S,D), dbc
// (B,G,S,2N), da (B,D,N), dh0 (B,D,N), hck as ``ssm_scan_bwd_sizes``
// counts it: contiguous f32.  N in {4, 8, 16}.  Returns
// cudaGetLastError() after the launch; does not synchronise.
extern "C" int ssm_scan_bwd_f32(
        const void* x, const void* dt, const void* b_in, const void* c_out,
        const void* a_log, const void* h0, const void* dy,
        const void* dh_end, void* dx, void* ddt, void* dbc, void* da,
        void* dh0, void* hck, int B, int S, int D, int N,
        long long x_sb, long long x_ss, long long x_sd,
        long long dt_sb, long long dt_ss, long long dt_sd,
        long long b_sb, long long b_ss, long long b_sn,
        long long c_sb, long long c_ss, long long c_sn, void* stream) {
    if (B < 1 || B > 65535 || S < 1 || D < 1)
        return (int)cudaErrorInvalidValue;
    const SbStrides st{x_sb, x_ss, x_sd, dt_sb, dt_ss, dt_sd,
                       b_sb, b_ss, b_sn, c_sb, c_ss, c_sn};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SB_ARGS static_cast<const float*>(x), static_cast<const float*>(dt), \
    static_cast<const float*>(b_in), static_cast<const float*>(c_out), \
    static_cast<const float*>(a_log), static_cast<const float*>(h0), \
    static_cast<const float*>(dy), static_cast<const float*>(dh_end), \
    static_cast<float*>(dx), static_cast<float*>(ddt), \
    static_cast<float*>(dbc), static_cast<float*>(da), \
    static_cast<float*>(dh0), static_cast<float*>(hck), B, S, D, st, s
    switch (N) {
        case 4: return launch_sb<4>(SB_ARGS);
        case 8: return launch_sb<8>(SB_ARGS);
        case 16: return launch_sb<16>(SB_ARGS);
    }
#undef SB_ARGS
    return (int)cudaErrorInvalidValue;
}
