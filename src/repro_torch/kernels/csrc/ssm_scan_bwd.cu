// The backward of K5, the diagonal selective scan of ssm_scan.cu, for
// Hopper (sm_90a): one kernel, time split as the forward splits it.
//
// The JAX package has no backward Pallas kernel: JAX differentiates the
// reference model's jnp scan, and its training never calls
// src/repro/kernels/ssm_scan.py: _kernel.  The port routes every CUDA
// tensor to its forward kernel, so a gradient through that kernel needs
// this one.
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
//   x, dt (B,S,D) and B_in, C_out (B,S,N) f32 or bf16 (dtype 0 or 1,
//   as ssm_scan_fwd) with any strides (the model's strided halves of one
//   (B,S,2N) tensor); dy (B,S,D) contiguous, of the same type; a_log
//   (D,N), h0 (B,D,N) or null, dh_end (B,D,N) or null, contiguous f32;
//   a bf16 input is widened to f32 where it is read, as the forward
//   widens it, and every state, carry and partial is f32;
//   fcar: the forward kernel's chunk carries (its ``carries`` scratch,
//   kept by the caller), which hold the state at the start of every
//   chunk but the first.  Out, contiguous f32: dx, ddt (B,S,D); dbc
//   (B,G,S,2N) -- per channel group of 32, dB then dC, the wrapper sums
//   the G axis; da (B,chunks,D,N) -- per (batch row, chunk), the wrapper
//   sums both axes; dh0 (B,D,N).  No float atomics: every cross-block
//   sum is a partial the wrapper adds up in a fixed order, so a gradient
//   is the same bits every run.
//
// Design.  The reverse recurrence of g is the same linear first-order
// scan as the forward's, run backward in time, so it splits the same way
// (ssm_scan.cu's header).  A CTA is one chunk of one (batch row, group
// of 32 channels), a lane a channel with its N states in registers, and
// warp w owns segment w of the chunk: the forward's split exactly (the
// caller passes the segment length and chunk count the forward kernel
// reports), so the forward's own chunk carries give each chunk's start
// state.
//   * Pass 1, each warp on its segment, both from zero: the forward scan
//     (its local end state and sum(dt), the forward kernel's pass 1
//     exactly) and the reverse scan of g (its carry out of the segment's
//     first step, a_tb * g_tb).
//   * The reverse carry between chunks: chunks are handed out in reverse
//     time order by an atomic ticket; a CTA waits on the flag of the
//     later chunk of its row (release / acquire), which a CTA that
//     started earlier sets, so no wait can deadlock, and a lost flag
//     traps rather than hangs.  Then each warp folds, in registers, the
//     forward's chunk carry over the earlier segments (its true start
//     state, the forward's fold exactly, so every replayed h_t equals
//     the forward's bit for bit) and the reverse carry over the later
//     segments, c <- exp2(a2 * sum dt_v) * c + c_v: N exps a segment.
//     Warp 0 folds its own segment too and publishes the chunk's carry
//     out before its second pass (for the first chunk that is dh0), so
//     the chain between chunks is one fold long.
//   * Pass 2, each warp on its segment: the states forward from the true
//     start, one checkpoint every SB_BLK steps in shared memory; then the
//     blocks last to first, each in two halves of SB_SUB steps whose
//     states sit in registers (the later half replayed from the block's
//     checkpoint after SB_SUB steps that are not kept), each half walked
//     back with the true g: dx and ddt written, dB and dC as a
//     reduce-scatter of 31 shuffles (N = 16) a step, dA_log's sum in
//     registers, summed over the CTA's warps in a fixed order at the end.
// The forward's arithmetic is replayed exactly: ex2.approx of dt * A *
// log2(e), the same fmaf order.
//
// Bound: the bytes (x, dt, dy, B, C read; dx, ddt, dB, dC written) and
// the B*S*D*N exps of a_t at the SFU's rate.  This design takes 5 + 1/2
// exps a state-step at the forward's 64-step segments (the two passes
// from zero, the checkpoint walk, the replays, the walk back) plus N a
// segment for the folds; its shared memory (161 KB at N = 16: the
// checkpoints) and registers (the sub-blocks' states) hold one CTA of 8
// warps an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int SB_WARPS = 8;        // segments a chunk: ssm_scan.cu's SS_WARPS
constexpr int SB_CH = 32;          // channels a CTA: one a lane
constexpr int SB_MAX_SEG = 64;     // longest segment: ssm_scan.cu's SS_SEG
constexpr int SB_BLK = 8;          // steps between checkpoints
constexpr int SB_SUB = 4;          // steps of a half block, in registers
constexpr int SB_CKS = SB_MAX_SEG / SB_BLK;   // checkpoints a warp
constexpr float SB_LOG2E = 1.4426950408889634f;
#define SB_SPIN_LIMIT (1 << 26)    // ~seconds: a lost carry traps

static_assert(SB_BLK == 2 * SB_SUB, "a block is two register halves");

struct SbStrides {
    long long x_b, x_s, x_d, dt_b, dt_s, dt_d;
    long long b_b, b_s, b_n, c_b, c_s, c_n;
};

__device__ __forceinline__ float sb_f32(float x) { return x; }
__device__ __forceinline__ float sb_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

__device__ __forceinline__ float sb_ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ int sb_flag_load(const int* f) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
                 : "=r"(v) : "l"(f) : "memory");
    return v;
}

__device__ __forceinline__ void sb_flag_set(int* f) {
    asm volatile("st.release.gpu.global.b32 [%0], %1;\n"
                 :: "l"(f), "r"(1) : "memory");
}

// Shared memory of one CTA, in floats: each warp's checkpoints, and its
// pass-1 results (local end state, reverse carry, sum of dt).
template <int N>
struct SbSmem {
    static constexpr int STATE = N * SB_CH;                  // [n][lane]
    static constexpr int CK = 0;                             // [w][j][..]
    static constexpr int HL = CK + SB_WARPS * SB_CKS * STATE;   // [w][..]
    static constexpr int GL = HL + SB_WARPS * STATE;            // [w][..]
    static constexpr int DT = GL + SB_WARPS * STATE;            // [w][lane]
    static constexpr int FLOATS = DT + SB_WARPS * SB_CH;
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

// What a lane reads of step t, widened to f32: its channel's x, dt, dy
// and the row's B_t, C_t (the same for every lane: broadcasts).  Zeros
// on a lane past D.
template <typename T>
struct SbIn {
    const T* x;
    const T* dt;
    const T* dy;
    const T* bm;
    const T* cm;
    SbStrides st;
    int D;
    bool ok;

    __device__ __forceinline__ float xv(int t) const {
        return ok ? sb_f32(x[t * st.x_s]) : 0.0f;
    }
    __device__ __forceinline__ float dtv(int t) const {
        return ok ? sb_f32(dt[t * st.dt_s]) : 0.0f;
    }
    __device__ __forceinline__ float dyv(int t) const {
        return ok ? sb_f32(dy[(long long)t * D]) : 0.0f;
    }
    __device__ __forceinline__ float bv(int t, int n) const {
        return sb_f32(bm[t * st.b_s + n * st.b_n]);
    }
    __device__ __forceinline__ float cv(int t, int n) const {
        return sb_f32(cm[t * st.c_s + n * st.c_n]);
    }
};

// One forward step, the forward kernel's arithmetic: h <- a_t h + dt x B
template <int N, typename In>
__device__ __forceinline__ void sb_step(const In& in, int t,
                                        const float (&a2)[N],
                                        float (&h)[N]) {
    const float dv = in.dtv(t);
    const float dxv = dv * in.xv(t);
#pragma unroll
    for (int n = 0; n < N; ++n)
        h[n] = fmaf(sb_ex2(dv * a2[n]), h[n], dxv * in.bv(t, n));
}

template <int N>
__device__ __forceinline__ void sb_load(float (&h)[N], const float* p) {
#pragma unroll
    for (int n = 0; n < N; ++n) h[n] = p[n * SB_CH];
}

template <int N>
__device__ __forceinline__ void sb_store(const float (&h)[N], float* p) {
#pragma unroll
    for (int n = 0; n < N; ++n) p[n * SB_CH] = h[n];
}

// One CTA is one chunk of one (batch row, group of SB_CH channels): an
// "item".  Items are numbered reverse-chunk-major, (chunks-1-k) * rows
// + (b * groups + g), and handed out in the order CTAs start (a ticket
// from ``sync[0]``), so the item a CTA waits on -- the same row's chunk
// k+1 -- belongs to a CTA that started earlier.  sync[1 + item] is
// item's flag; gcar[item] (N x 32 floats) its reverse carry out.
template <typename T, int N>
__global__ void __launch_bounds__(SB_WARPS * 32, 1)
ssm_scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const T* __restrict__ bm, const T* __restrict__ cm,
                    const float* __restrict__ a_log,
                    const float* __restrict__ h0,
                    const float* __restrict__ fcar,
                    const T* __restrict__ dy,
                    const float* __restrict__ dh_end,
                    float* __restrict__ dx, float* __restrict__ ddt,
                    float* __restrict__ dbc, float* __restrict__ da,
                    float* __restrict__ dh0, int* __restrict__ sync,
                    float* __restrict__ gcar, int S, int D, int seg,
                    int chunks, SbStrides st) {
    using SM = SbSmem<N>;
    constexpr int V = 2 * N;
    extern __shared__ __align__(16) float sb_smem[];
    __shared__ int ticket;
    const int w = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    if (threadIdx.x == 0) ticket = atomicAdd(sync, 1);
    __syncthreads();
    const int groups = (D + SB_CH - 1) / SB_CH;
    const int rows = (int)(gridDim.x / chunks);            // B * groups
    const int item = ticket;
    const int kr = item / rows;                            // reverse rank
    const int k = chunks - 1 - kr;
    const int row = item % rows;
    const int b = row / groups;
    const int g = row % groups;
    const int d = g * SB_CH + lane;
    const bool ok = d < D;
    const int dd = ok ? d : 0;
    const long long hrow = ((long long)b * D + dd) * N;

    float A[N], a2[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
        A[n] = ok ? -expf(a_log[(long long)d * N + n]) : 0.0f;
        a2[n] = A[n] * SB_LOG2E;
    }
    SbIn<T> in;
    in.x = x + b * st.x_b + dd * st.x_d;
    in.dt = dt + b * st.dt_b + dd * st.dt_d;
    in.dy = dy + (long long)b * S * D + dd;
    in.bm = bm + b * st.b_b;
    in.cm = cm + b * st.c_b;
    in.st = st;
    in.D = D;
    in.ok = ok;

    const int tb = k * SB_WARPS * seg + w * seg;
    const int te = min(tb + seg, S);
    float* hl = sb_smem + SM::HL;
    float* gl = sb_smem + SM::GL;
    float* sums = sb_smem + SM::DT;

    // pass 1: the segment forward from zero (local end state, sum dt)
    // and g backward from zero (the carry out of its first step)
    {
        float h[N];
        float sdt = 0.0f;
#pragma unroll
        for (int n = 0; n < N; ++n) h[n] = 0.0f;
#pragma unroll 2
        for (int t = tb; t < te; ++t) {
            sb_step<N>(in, t, a2, h);
            sdt += in.dtv(t);
        }
        sb_store<N>(h, hl + w * SM::STATE + lane);
        sums[w * SB_CH + lane] = sdt;
        float c[N];
#pragma unroll
        for (int n = 0; n < N; ++n) c[n] = 0.0f;
#pragma unroll 2
        for (int t = te - 1; t >= tb; --t) {
            const float dv = in.dtv(t);
            const float dyv = in.dyv(t);
#pragma unroll
            for (int n = 0; n < N; ++n)
                c[n] = sb_ex2(dv * a2[n]) * fmaf(in.cv(t, n), dyv, c[n]);
        }
        sb_store<N>(c, gl + w * SM::STATE + lane);
    }
    // the later chunk's reverse carry
    if (kr > 0 && threadIdx.x == 0) {
        const int* flag = sync + 1 + (item - rows);
        int spins = 0;
        while (sb_flag_load(flag) == 0) {
            __nanosleep(64);
            if (++spins > SB_SPIN_LIMIT) __trap();
        }
    }
    __syncthreads();

    // the true state at the segment's start: the forward's chunk carry
    // (h0 for the first chunk) folded over the earlier segments
    float h[N];
    if (k > 0) {
        const float* cin = fcar + ((long long)(k - 1) * rows + row) * N * 32;
#pragma unroll
        for (int n = 0; n < N; ++n) h[n] = cin[n * 32 + lane];
    } else {
#pragma unroll
        for (int n = 0; n < N; ++n) h[n] = (ok && h0) ? h0[hrow + n] : 0.0f;
    }
    for (int v = 0; v < w; ++v) {
        const float s = sums[v * SB_CH + lane];
#pragma unroll
        for (int n = 0; n < N; ++n)
            h[n] = fmaf(sb_ex2(a2[n] * s), h[n],
                        hl[v * SM::STATE + n * SB_CH + lane]);
    }
    // the true reverse carry into the segment's last step: the later
    // chunk's (dh_end for the last chunk) folded over the later segments
    float gr[N];
    if (kr > 0) {
        const float* cin = gcar + (long long)(item - rows) * N * 32;
#pragma unroll
        for (int n = 0; n < N; ++n) gr[n] = __ldcg(cin + n * 32 + lane);
    } else {
#pragma unroll
        for (int n = 0; n < N; ++n)
            gr[n] = (ok && dh_end) ? dh_end[hrow + n] : 0.0f;
    }
    for (int v = SB_WARPS - 1; v > w; --v) {
        const float s = sums[v * SB_CH + lane];
#pragma unroll
        for (int n = 0; n < N; ++n)
            gr[n] = fmaf(sb_ex2(a2[n] * s), gr[n],
                         gl[v * SM::STATE + n * SB_CH + lane]);
    }
    if (w == 0) {
        // the chunk's reverse carry out, over segment 0 too: published
        // for the earlier chunk, or dh0 = a_0 g_0 for the first
        const float s0 = sums[lane];
        float* cout = gcar + (long long)item * N * 32;
#pragma unroll
        for (int n = 0; n < N; ++n) {
            const float carry = fmaf(sb_ex2(a2[n] * s0), gr[n],
                                     gl[n * SB_CH + lane]);
            if (k > 0) __stcg(cout + n * 32 + lane, carry);
            else if (ok) dh0[hrow + n] = carry;
        }
        if (k > 0) {
            __threadfence();
            __syncwarp();
            if (lane == 0) sb_flag_set(sync + 1 + item);
        }
    }

    // pass 2: checkpoints every SB_BLK steps from the true start
    float* ck = sb_smem + SM::CK + w * SB_CKS * SM::STATE + lane;
    const int nb = te > tb ? (te - tb + SB_BLK - 1) / SB_BLK : 0;
    for (int j = 0; j < nb; ++j) {
        sb_store<N>(h, ck + j * SM::STATE);
        if (j + 1 < nb) {
#pragma unroll 2
            for (int t = tb + j * SB_BLK; t < tb + (j + 1) * SB_BLK; ++t)
                sb_step<N>(in, t, a2, h);
        }
    }
    __syncwarp();
    float dacc[N];
#pragma unroll
    for (int n = 0; n < N; ++n) dacc[n] = 0.0f;
    const int q_mine = lane / (SB_CH / V);
    const bool writer = lane % (SB_CH / V) == 0;
    float* dbc_row = dbc + ((long long)b * groups + g) * S * V;
    // the blocks last to first, each as two halves, the later first
    for (int j = nb - 1; j >= 0; --j) {
        const int s0 = tb + j * SB_BLK;
        const int s1 = min(s0 + SB_BLK, te);
        for (int half = 1; half >= 0; --half) {
            const int a0 = s0 + half * SB_SUB;
            const int cnt = min(SB_SUB, s1 - a0);
            if (cnt <= 0) continue;                       // warp-uniform
            float hs[SB_SUB + 1][N];
            sb_load<N>(hs[0], ck + j * SM::STATE);
            if (half) {
#pragma unroll
                for (int i = 0; i < SB_SUB; ++i)
                    sb_step<N>(in, s0 + i, a2, hs[0]);
            }
#pragma unroll
            for (int i = 0; i < SB_SUB; ++i) {
                if (i < cnt) {
#pragma unroll
                    for (int n = 0; n < N; ++n) hs[i + 1][n] = hs[i][n];
                    sb_step<N>(in, a0 + i, a2, hs[i + 1]);
                }
            }
#pragma unroll
            for (int i = SB_SUB - 1; i >= 0; --i) {
                if (i >= cnt) continue;
                const int t = a0 + i;
                const float dv = in.dtv(t);
                const float xv = in.xv(t);
                const float dyv = in.dyv(t);
                const float dtx = dv * xv;
                float vals[V];
                float sx = 0.0f, sdt = 0.0f;
#pragma unroll
                for (int n = 0; n < N; ++n) {
                    const float hc = hs[i + 1][n];
                    const float hp = hs[i][n];
                    const float a = sb_ex2(dv * a2[n]);
                    const float bn = in.bv(t, n);
                    gr[n] = fmaf(in.cv(t, n), dyv, gr[n]);
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
                if (writer) dbc_row[(long long)t * V + q_mine] = part;
            }
        }
    }

    // dA_log's partial of this (batch row, chunk): the warps' sums in
    // order (the pass-1 slots are free: every fold has read them)
    __syncthreads();
    sb_store<N>(dacc, hl + w * SM::STATE + lane);
    __syncthreads();
    if (w == 0 && ok) {
        float* drow = da + (((long long)b * chunks + k) * D + d) * N;
#pragma unroll
        for (int n = 0; n < N; ++n) {
            float sum = hl[n * SB_CH + lane];
            for (int v = 1; v < SB_WARPS; ++v)
                sum += hl[v * SM::STATE + n * SB_CH + lane];
            drow[n] = A[n] * sum;
        }
    }
}

// T (float or bf16) from the inputs' pointer type
template <int N, typename T>
static int launch_sb(const T* x, const T* dt, const T* bm, const T* cm,
                     const float* a_log, const float* h0, const float* fcar,
                     const T* dy, const float* dh_end, float* dx,
                     float* ddt, float* dbc, float* da, float* dh0,
                     int* sync, float* gcar, int B, int S, int D, int seg,
                     int chunks, const SbStrides& st, cudaStream_t stream) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssm_scan_bwd_kernel<T, N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SbSmem<N>::BYTES);
    if (err != cudaSuccess) return (int)err;
    const long long items =
        (long long)B * ((D + SB_CH - 1) / SB_CH) * chunks;
    if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    ssm_scan_bwd_kernel<T, N><<<(unsigned)items, SB_WARPS * 32,
                                SbSmem<N>::BYTES, stream>>>(
        x, dt, bm, cm, a_log, h0, fcar, dy, dh_end, dx, ddt, dbc, da, dh0,
        sync, gcar, S, D, seg, chunks, st);
    return (int)cudaGetLastError();
}

// Sizes of one call of ``chunks`` chunks, and the kernel's own
// constants: which = 0, the int32 count of ``sync`` (zeroed: a ticket
// counter and a flag an item); 1, the f32 count of ``gcar``; 2, the
// channel groups G of the dB|dC partial (B,G,S,2N); 3, the segments
// (warps) a chunk it takes; 4, the steps between checkpoints; 5, the
// steps of a register half block.
extern "C" long long ssm_scan_bwd_sizes(int B, int S, int D, int N,
                                        int chunks, int which) {
    if (B < 1 || S < 1 || D < 1 || N < 1 || chunks < 1) return 0;
    const long long groups = (D + SB_CH - 1) / SB_CH;
    const long long items = (long long)B * groups * chunks;
    switch (which) {
        case 0: return 1 + items;
        case 1: return items * N * 32;
        case 2: return groups;
        case 3: return SB_WARPS;
        case 4: return SB_BLK;
        case 5: return SB_SUB;
        default: return -1;
    }
}

// x, dt (B,S,D), b_in, c_out (B,S,N) of dtype (0: f32, 1: bf16) with
// element strides (batch, time, channel/state), dy (B,S,D) contiguous of
// the same dtype; a_log (D,N), h0 (B,D,N) or null, fcar (the forward's
// carries under the same split; null when chunks = 1), dh_end (B,D,N)
// or null: contiguous f32.  seg, warps, chunks:
// the forward kernel's split of S (ssm_scan_scratch which = 2, 3, 4;
// any seg with warps * seg * chunks >= S for S = 1).  dx, ddt (B,S,D),
// dbc (B,G,S,2N), da (B,chunks,D,N), dh0 (B,D,N), sync and gcar as
// ``ssm_scan_bwd_sizes`` counts them: contiguous.  N in {4, 8, 16}.
// Returns cudaGetLastError() after the launch; does not synchronise.
extern "C" int ssm_scan_bwd(
        const void* x, const void* dt, const void* b_in, const void* c_out,
        const void* a_log, const void* h0, const void* fcar, const void* dy,
        const void* dh_end, void* dx, void* ddt, void* dbc, void* da,
        void* dh0, void* sync, void* gcar, int dtype, int B, int S, int D,
        int N, int seg, int warps, int chunks,
        long long x_sb, long long x_ss, long long x_sd,
        long long dt_sb, long long dt_ss, long long dt_sd,
        long long b_sb, long long b_ss, long long b_sn,
        long long c_sb, long long c_ss, long long c_sn, void* stream) {
    if (B < 1 || S < 1 || D < 1 || warps != SB_WARPS || seg < 1
            || seg > SB_MAX_SEG || chunks < 1
            || (long long)chunks * SB_WARPS * seg < S
            || (long long)(chunks - 1) * SB_WARPS * seg >= S
            || (chunks > 1 && fcar == nullptr) || sync == nullptr
            || gcar == nullptr || (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    const SbStrides st{x_sb, x_ss, x_sd, dt_sb, dt_ss, dt_sd,
                       b_sb, b_ss, b_sn, c_sb, c_ss, c_sn};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SB_ARGS(T) static_cast<const T*>(x), static_cast<const T*>(dt), \
    static_cast<const T*>(b_in), static_cast<const T*>(c_out), \
    static_cast<const float*>(a_log), static_cast<const float*>(h0), \
    static_cast<const float*>(fcar), static_cast<const T*>(dy), \
    static_cast<const float*>(dh_end), static_cast<float*>(dx), \
    static_cast<float*>(ddt), static_cast<float*>(dbc), \
    static_cast<float*>(da), static_cast<float*>(dh0), \
    static_cast<int*>(sync), static_cast<float*>(gcar), B, S, D, seg, \
    chunks, st, s
    if (dtype == 0) {
        switch (N) {
            case 4: return launch_sb<4>(SB_ARGS(float));
            case 8: return launch_sb<8>(SB_ARGS(float));
            case 16: return launch_sb<16>(SB_ARGS(float));
        }
    } else {
        switch (N) {
            case 4: return launch_sb<4>(SB_ARGS(__nv_bfloat16));
            case 8: return launch_sb<8>(SB_ARGS(__nv_bfloat16));
            case 16: return launch_sb<16>(SB_ARGS(__nv_bfloat16));
        }
    }
#undef SB_ARGS
    return (int)cudaErrorInvalidValue;
}
