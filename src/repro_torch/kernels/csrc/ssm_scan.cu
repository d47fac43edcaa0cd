// Diagonal selective-SSM scan for Hopper (sm_90a), split over time.
//
//   per batch b, channel d, state n (A = -exp(a_log[d][n])):
//     h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t      (f32)
//     y_t = <h_t, C_t> = sum_n h_t[n] * C_t[n]
//   x, dt (B,S,D) and B_in, C_out (B,S,N) in f32 or bf16, any strides
//   (the model passes B_in and C_out as the two halves of one (B,S,2N)
//   tensor, strided views, no copies); a_log (D,N) f32; the starting
//   state h0 (B,D,N) f32 or null (zeros); y (B,S,D) contiguous in x's
//   type, rounded once; h_end (B,D,N) f32 is the state after the last
//   step, so a prefill hands its state to decode and a decode step
//   (S = 1) is one launch with the carried state.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py: _kernel /
// ssm_scan, which walks time sequentially on purpose -- a TPU grid runs
// in order, so the (block_d, N) state carries in VMEM from one time
// chunk to the next; it also serves the reference model's chunked
// associative scan (src/repro/models/ssm.py: ssm_core, h0 in, h_end
// out).  On Hopper blocks run in parallel and a serial chain of S steps
// per state leaves the card idle, so time is split across warps:
//
//   * Lanes on channels, states in registers: a warp takes 32
//     consecutive channels of one batch row (x, dt and y rows read and
//     written 64 or 128 bytes at a time); each thread holds all N states
//     of its channel and a2 = A * log2(e), and sums y_t = sum_n h_n
//     C_t,n itself, with no shuffles.  B_t and C_t (the same for every
//     channel of the row) are staged per warp in shared memory and read
//     as broadcasts.  (Sharing a channel among 2 or 4 lanes, with a
//     shuffle sum for y, spilled at its register cap and was slower:
//     tools/k5_variants.py, PERF.md.)
//   * Time in chunks of SS_WARPS segments of L steps (L <= SS_SEG, in
//     whole blocks of SS_TB, shorter for short sequences); a CTA is one
//     chunk of one (batch row, channel group), and warp w owns segment
//     w of it.  Pass 1: each warp scans its segment from a zero state,
//     giving its local end state and sum(dt).  After one __syncthreads,
//     each warp forms its own carry in registers: the chunk's carry-in
//     folded over the earlier segments, c <- exp2(a2 * sum(dt_v)) * c +
//     h_v (N exps a segment, not a step).  Pass 2 reruns the segment
//     from that carry and writes y.  The last warp's state after pass 2
//     is the chunk's carry-out (after the last chunk, h_end).
//   * Chunks of one row are CTAs of their own, so the card balances
//     1600 equal CTAs at the serving prefill, where 200 whole-sequence
//     CTAs left the busiest SMs with 2 where 1.52 would be even.  The
//     chunk-in carry comes from the CTA of chunk k-1 through global
//     memory and a flag (release / acquire); pass 1 does not need it,
//     so a CTA waits, if at all, only before pass 2.  Chunks are handed
//     out in the order CTAs start (an atomic ticket), chunk-major, so a
//     CTA only ever waits on one that started before it: no wait can
//     deadlock, and one lost flag traps rather than hangs.  One launch,
//     no grid-wide sync; the caller zeroes the tickets and flags.
//   * Each warp stages SS_TB steps of x, dt, B, C at a time through
//     registers into its own shared memory: the next block's loads are
//     in flight while the current block is computed.  Steps past the
//     segment's end are zeros, an exact no-op (exp2(0) = 1, nothing
//     added): no path forms 0 * inf, and channels past D stay zero.
//   * exps by ex2.approx.ftz with log2(e) folded into a2 once.
//   * S = 1 (a decode step) is its own kernel in the same entry: a lane
//     per (b, d, n) state, one step from h0, y as an N-lane shuffle sum
//     -- coalesced h0 and h_end, no segments, no staging.
//
// Bound: the exps.  The function needs B*S*D*N of them (0.100 ms at the
// serving prefill, B=2, S=4096, D=3200, N=16, at the SFU's 16 a clock an
// SM); this design takes two per (t, d, n) -- one in each pass -- plus
// N per earlier segment of a chunk for the carries, so its floor is
// 0.202 ms there.  The bytes (x, dt read, y written once; B, C once per
// row) are ~0.05 ms.  ptxas (-Xptxas -v, tools/k5_variants.py): 120-128
// registers at 256 threads and two CTAs an SM, no spills; 4 staged
// steps, 8 warps, segments of at most 64 steps, measured against their
// neighbours in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

constexpr int SS_WARPS = 8;        // time segments of a chunk: one warp each
constexpr int SS_SEG = 64;         // longest segment (steps)
constexpr int SS_TB = 4;           // steps a warp stages at a time
constexpr int SS_MIN_BLOCKS = 2;   // CTAs an SM holds: a thread's registers
constexpr int SS_CH = 32;          // channels a CTA: one a lane
constexpr int SS_STEP_THREADS = 256;

static_assert(SS_SEG % SS_TB == 0, "segments are whole staging blocks");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_as(float v, __nv_bfloat16* p) {
    *p = __float2bfloat16_rn(v);
}
template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
    return __float2bfloat16_rn(0.0f);
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// K consecutive floats of shared memory, 16 or 8 bytes at a time where
// they allow
template <int K>
__device__ __forceinline__ void load_row(const float* p, float (&v)[K]) {
    if constexpr (K % 4 == 0) {
#pragma unroll
        for (int q = 0; q < K / 4; ++q) {
            const float4 f = reinterpret_cast<const float4*>(p)[q];
            v[4 * q] = f.x; v[4 * q + 1] = f.y;
            v[4 * q + 2] = f.z; v[4 * q + 3] = f.w;
        }
    } else if constexpr (K % 2 == 0) {
#pragma unroll
        for (int q = 0; q < K / 2; ++q) {
            const float2 f = reinterpret_cast<const float2*>(p)[q];
            v[2 * q] = f.x; v[2 * q + 1] = f.y;
        }
    } else {
#pragma unroll
        for (int q = 0; q < K; ++q) v[q] = p[q];
    }
}

constexpr float SS_LOG2E = 1.4426950408889634f;

struct SsStrides {
    long long x_b, x_s, x_d, dt_b, dt_s, dt_d;
    long long b_b, b_s, b_n, c_b, c_s, c_n;
};

// Shared memory of the scan kernel, in floats: a staging area a warp,
// then the chunk's segment slots.
template <int N>
struct SsSmem {
    static constexpr int XS = SS_TB * SS_CH;       // x or dt, [step][chan]
    static constexpr int BC = SS_TB * 2 * N;       // B|C, [step][2N]
    static constexpr int STAGE = 2 * XS + BC;      // a warp's
    static constexpr int SLOT = (N + 1) * 32;      // h [n][lane], sum dt
    static constexpr int SLOT_OFF = SS_WARPS * STAGE;
    static constexpr int FLOATS = SLOT_OFF + SS_WARPS * SLOT;
    static constexpr int BYTES = FLOATS * 4;
    static_assert(XS % 4 == 0 && BC % 4 == 0, "16-byte aligned areas");
};

// The time split of a sequence of S steps: segments of whole staging
// blocks, at most SS_SEG, SS_WARPS of them a chunk.
struct SsSplit {
    int seg, chunk, chunks;
    __host__ __device__ explicit SsSplit(int S) {
        const int per = (S + SS_WARPS - 1) / SS_WARPS;
        const int s = (per + SS_TB - 1) / SS_TB * SS_TB;
        seg = s < SS_SEG ? s : SS_SEG;
        chunk = SS_WARPS * seg;
        chunks = (S + chunk - 1) / chunk;
    }
};

// A chunk's carry-out, published by one CTA for the next chunk's: the
// flag is set once the carry's stores are visible on the device.
__device__ __forceinline__ int ss_flag_load(const int* f) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
                 : "=r"(v) : "l"(f) : "memory");
    return v;
}
__device__ __forceinline__ void ss_flag_set(int* f) {
    asm volatile("st.release.gpu.global.b32 [%0], %1;\n"
                 :: "l"(f), "r"(1) : "memory");
}
#define SS_SPIN_LIMIT (1 << 26)   // ~seconds: a lost carry traps

// What a lane reads: channel c of the CTA's, its x and dt, and one
// element of the row's B|C, the (lane % 2N)-th, at steps lane / 2N + k *
// 32/2N of a staged block.
template <typename T>
struct SsLane {
    const T* x;             // x and dt of the channel at t = 0
    const T* dt;
    long long xs, dts;      // time strides
    const T* bc;
    long long bcs;
    int tt0;
    int c;
    bool ok;                // a channel < D
};

// One segment [t_begin, t_end) of one warp: h (the channel's N states)
// advanced step by step; without y, sum(dt) into ``sdt``; with y, each
// step's y_t written to ``yp`` (time stride D).
template <typename T, int N, bool WITH_Y>
__device__ __forceinline__ void run_segment(const SsLane<T>& c, float* stage,
                                            int t_begin, int t_end,
                                            float (&h)[N],
                                            const float (&a2)[N],
                                            float& sdt, T* yp, long long D) {
    constexpr int KB = SS_TB * 2 * N / 32;    // B|C elements a lane stages
    constexpr int KSTEP = 32 / (2 * N);       // steps between them
    if (t_begin >= t_end) return;             // warp-uniform
    const int lane = threadIdx.x & 31;
    float* xs = stage;
    float* ds = stage + SsSmem<N>::XS;
    float* bcs = stage + 2 * SsSmem<N>::XS;
    T px[SS_TB], pd[SS_TB], pb[KB];
    auto fetch = [&](int t0) {
        const T* xp = c.x + (long long)t0 * c.xs;
        const T* dp = c.dt + (long long)t0 * c.dts;
#pragma unroll
        for (int i = 0; i < SS_TB; ++i) {
            const bool in = c.ok && t0 + i < t_end;
            px[i] = in ? xp[i * c.xs] : zero_of<T>();
            pd[i] = in ? dp[i * c.dts] : zero_of<T>();
        }
#pragma unroll
        for (int k = 0; k < KB; ++k) {
            const int t = t0 + c.tt0 + k * KSTEP;
            pb[k] = t < t_end ? c.bc[(long long)t * c.bcs] : zero_of<T>();
        }
    };
    fetch(t_begin);
    for (int t0 = t_begin; t0 < t_end; t0 += SS_TB) {
        __syncwarp();                 // the last block's reads are done
#pragma unroll
        for (int i = 0; i < SS_TB; ++i) {
            xs[i * SS_CH + c.c] = to_f32(px[i]);
            ds[i * SS_CH + c.c] = to_f32(pd[i]);
        }
#pragma unroll
        for (int k = 0; k < KB; ++k) bcs[lane + 32 * k] = to_f32(pb[k]);
        __syncwarp();
        if (t0 + SS_TB < t_end) fetch(t0 + SS_TB);   // in flight meanwhile
#pragma unroll
        for (int i = 0; i < SS_TB; ++i) {
            const float dv = ds[i * SS_CH + c.c];
            const float dx = dv * xs[i * SS_CH + c.c];
            const float* row = bcs + i * 2 * N;
            float bv[N], cv[N];
            load_row<N>(row, bv);
            if (WITH_Y) load_row<N>(row + N, cv);
            float yv = 0.0f;
#pragma unroll
            for (int n = 0; n < N; ++n) {
                const float da = ex2(dv * a2[n]);
                h[n] = fmaf(da, h[n], dx * bv[n]);
                if (WITH_Y) yv = fmaf(h[n], cv[n], yv);
            }
            if (WITH_Y) {
                if (c.ok && t0 + i < t_end)
                    store_as(yv, yp + (long long)(t0 + i) * D);
            } else {
                sdt += dv;
            }
        }
    }
}

// One CTA is one chunk of one (batch row, group of SS_CH channels): an
// "item".  Items are numbered chunk-major, k * rows + (b * groups + g),
// and handed out in the order CTAs start (a ticket from ``sync[0]``), so
// the item a CTA waits on -- the same row's chunk k-1 -- belongs to a
// CTA that started earlier and waits only on earlier ones: no CTA can
// wait on one that is not running.  sync[1 + item] is item's flag;
// carries[item] (N x 32 floats) its carry-out.
template <typename T, int N>
__global__ void __launch_bounds__(SS_WARPS * 32, SS_MIN_BLOCKS)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const T* __restrict__ bm, const T* __restrict__ cm,
                const float* __restrict__ a_log,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ h_end, int S, int D, SsStrides st,
                int* __restrict__ sync, float* __restrict__ carries) {
    using SM = SsSmem<N>;
    extern __shared__ __align__(16) float ss_smem[];
    __shared__ int ticket;
    const int w = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    if (threadIdx.x == 0) ticket = atomicAdd(sync, 1);
    __syncthreads();
    const int groups = (D + SS_CH - 1) / SS_CH;
    const int rows = (int)(gridDim.x / SsSplit(S).chunks);   // B * groups
    const int item = ticket;
    const int k = item / rows;
    const int b = (item % rows) / groups;
    const int g = (item % rows) % groups;

    SsLane<T> c;
    c.c = lane;
    const int d = g * SS_CH + c.c;
    const bool ok = d < D;
    const int dd = ok ? d : 0;
    c.ok = ok;

    float a2[N];
#pragma unroll
    for (int n = 0; n < N; ++n)
        a2[n] = ok ? -expf(a_log[(long long)d * N + n]) * SS_LOG2E : 0.0f;

    c.x = x + b * st.x_b + dd * st.x_d;
    c.xs = st.x_s;
    c.dt = dt + b * st.dt_b + dd * st.dt_d;
    c.dts = st.dt_s;
    const int j = lane % (2 * N);
    c.bc = j < N ? bm + b * st.b_b + j * st.b_n
                 : cm + b * st.c_b + (j - N) * st.c_n;
    c.bcs = j < N ? st.b_s : st.c_s;
    c.tt0 = lane / (2 * N);
    T* yp = y + (long long)b * S * D + dd;

    const SsSplit split(S);
    float* stage = ss_smem + w * SM::STAGE;
    float* slots = ss_smem + SM::SLOT_OFF;     // [warp][SLOT]
    const long long hrow = ((long long)b * D + dd) * N;
    const int tb = k * split.chunk + w * split.seg;
    const int te = min(tb + split.seg, S);

    // pass 1: this segment from a zero state
    float h[N];
    float sdt = 0.0f;
#pragma unroll
    for (int n = 0; n < N; ++n) h[n] = 0.0f;
    run_segment<T, N, false>(c, stage, tb, te, h, a2, sdt, yp, D);
    float* mine = slots + w * SM::SLOT;
#pragma unroll
    for (int n = 0; n < N; ++n) mine[n * 32 + lane] = h[n];
    mine[N * 32 + lane] = sdt;
    // the chunk's carry-in: h0 (or zeros), or chunk k-1's carry-out
    if (k > 0 && threadIdx.x == 0) {
        const int* flag = sync + 1 + (item - rows);
        int spins = 0;
        while (ss_flag_load(flag) == 0) {
            __nanosleep(64);
            if (++spins > SS_SPIN_LIMIT) __trap();
        }
    }
    __syncthreads();
    const float* cin = carries + (long long)max(item - rows, 0) * N * 32;
#pragma unroll
    for (int n = 0; n < N; ++n)
        h[n] = k > 0 ? __ldcg(cin + n * 32 + lane)
                     : ((ok && h0) ? h0[hrow + n] : 0.0f);
    // the carry into this segment: the chunk's, over the earlier ones
    for (int v = 0; v < w; ++v) {
        const float* sv = slots + v * SM::SLOT;
        const float s = sv[N * 32 + lane];
#pragma unroll
        for (int n = 0; n < N; ++n)
            h[n] = fmaf(ex2(a2[n] * s), h[n], sv[n * 32 + lane]);
    }
    // pass 2: rerun from the carry, writing y
    run_segment<T, N, true>(c, stage, tb, te, h, a2, sdt, yp, D);
    if (w == SS_WARPS - 1) {
        if (k == split.chunks - 1) {
            if (ok) {
#pragma unroll
                for (int n = 0; n < N; ++n) h_end[hrow + n] = h[n];
            }
        } else {
            float* cout = carries + (long long)item * N * 32;
#pragma unroll
            for (int n = 0; n < N; ++n) __stcg(cout + n * 32 + lane, h[n]);
            __threadfence();
            __syncwarp();
            if (lane == 0) ss_flag_set(sync + 1 + item);
        }
    }
}

// S = 1: one step from h0, a lane per (b, d, n), 256/N channels a block.
template <typename T, int N>
__global__ void __launch_bounds__(SS_STEP_THREADS)
ssm_step_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const T* __restrict__ bm, const T* __restrict__ cm,
                const float* __restrict__ a_log,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ h_end, int B, int D, SsStrides st) {
    const long long i = (long long)blockIdx.x * SS_STEP_THREADS + threadIdx.x;
    const int n = (int)(i % N);
    const long long bd = i / N;
    const bool ok = bd < (long long)B * D;
    const int b = ok ? (int)(bd / D) : 0;
    const int d = ok ? (int)(bd % D) : 0;
    float h = 0.0f, part = 0.0f;
    if (ok) {
        const float a2 = -expf(a_log[(long long)d * N + n]) * SS_LOG2E;
        if (h0) h = h0[bd * N + n];
        const float dv = to_f32(dt[b * st.dt_b + d * st.dt_d]);
        const float xv = to_f32(x[b * st.x_b + d * st.x_d]);
        const float bv = to_f32(bm[b * st.b_b + n * st.b_n]);
        const float cv = to_f32(cm[b * st.c_b + n * st.c_n]);
        h = fmaf(ex2(dv * a2), h, (dv * xv) * bv);
        part = h * cv;
    }
#pragma unroll
    for (int off = N / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
    if (ok) {
        h_end[bd * N + n] = h;
        if (n == 0) store_as(part, y + bd);      // y (B,1,D): index b*D+d
    }
}

template <typename T, int N>
static int launch_ss(const void* x, const void* dt, const void* bm,
                     const void* cm, const float* a_log, const float* h0,
                     void* y, float* h_end, int B, int S, int D,
                     const SsStrides& st, int* sync, float* carries,
                     cudaStream_t stream) {
    if (S == 1) {
        const long long lanes = (long long)B * D * N;
        const unsigned blocks =
            (unsigned)((lanes + SS_STEP_THREADS - 1) / SS_STEP_THREADS);
        ssm_step_kernel<T, N><<<blocks, SS_STEP_THREADS, 0, stream>>>(
            static_cast<const T*>(x), static_cast<const T*>(dt),
            static_cast<const T*>(bm), static_cast<const T*>(cm), a_log, h0,
            static_cast<T*>(y), h_end, B, D, st);
        return (int)cudaGetLastError();
    }
    if (sync == nullptr || carries == nullptr)
        return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        ssm_scan_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SsSmem<N>::BYTES);
    if (err != cudaSuccess) return (int)err;
    const long long items =
        (long long)B * ((D + SS_CH - 1) / SS_CH) * SsSplit(S).chunks;
    if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    ssm_scan_kernel<T, N><<<(unsigned)items, SS_WARPS * 32,
                            SsSmem<N>::BYTES, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dt),
        static_cast<const T*>(bm), static_cast<const T*>(cm), a_log, h0,
        static_cast<T*>(y), h_end, S, D, st, sync, carries);
    return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_n(const void* x, const void* dt, const void* bm,
                      const void* cm, const float* a_log, const float* h0,
                      void* y, float* h_end, int B, int S, int D, int N,
                      const SsStrides& st, int* sync, float* carries,
                      cudaStream_t s) {
#define SS_ARGS x, dt, bm, cm, a_log, h0, y, h_end, B, S, D, st, sync, \
                carries, s
    switch (N) {
        case 4: return launch_ss<T, 4>(SS_ARGS);
        case 8: return launch_ss<T, 8>(SS_ARGS);
        case 16: return launch_ss<T, 16>(SS_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
#undef SS_ARGS
}

// Scratch of one call, allocated by the caller: which = 0, the int32
// count of ``sync`` (zeroed: a ticket counter and a flag an item); which
// = 1, the f32 count of ``carries``.  Both 0 for S = 1 (no scratch).
// And the time split the scan takes for S steps, for a caller that
// counts its work: which = 2, the segment length; 3, the segments (warps)
// a chunk; 4, the chunks.  All 0 for S = 1 (the step kernel).
extern "C" long long ssm_scan_scratch(int B, int S, int D, int N,
                                      int which) {
    if (S <= 1 || B < 1 || D < 1 || N < 1) return 0;
    const SsSplit split(S);
    const long long items =
        (long long)B * ((D + SS_CH - 1) / SS_CH) * split.chunks;
    switch (which) {
        case 0: return 1 + items;
        case 1: return items * N * 32;
        case 2: return split.seg;
        case 3: return SS_WARPS;
        case 4: return split.chunks;
        default: return -1;
    }
}

// x, dt (B,S,D) and b_in, c_out (B,S,N) with element strides (batch,
// time, channel/state); a_log (D,N) f32 contiguous; h0 (B,D,N) f32
// contiguous or null; y (B,S,D) contiguous; h_end (B,D,N) f32
// contiguous; sync and carries as ``ssm_scan_scratch`` counts them
// (null for S = 1).  dtype 0 = f32, 1 = bf16 (x, dt, b_in, c_out and
// y); N in {4, 8, 16}.  Returns cudaGetLastError() after the launch (or
// the error that kept it from launching); does not synchronise.
extern "C" int ssm_scan_fwd(
        const void* x, const void* dt, const void* b_in, const void* c_out,
        const void* a_log, const void* h0, void* y, void* h_end, int dtype,
        int B, int S, int D, int N,
        long long x_sb, long long x_ss, long long x_sd,
        long long dt_sb, long long dt_ss, long long dt_sd,
        long long b_sb, long long b_ss, long long b_sn,
        long long c_sb, long long c_ss, long long c_sn, void* stream,
        void* sync, void* carries) {
    if (B < 1 || B > 65535 || S < 1 || D < 1)
        return (int)cudaErrorInvalidValue;
    const SsStrides st{x_sb, x_ss, x_sd, dt_sb, dt_ss, dt_sd,
                       b_sb, b_ss, b_sn, c_sb, c_ss, c_sn};
    const float* al = static_cast<const float*>(a_log);
    const float* hp = static_cast<const float*>(h0);
    float* he = static_cast<float*>(h_end);
    int* sy = static_cast<int*>(sync);
    float* ca = static_cast<float*>(carries);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return dispatch_n<float>(x, dt, b_in, c_out, al, hp, y, he,
                                         B, S, D, N, st, sy, ca, s);
        case 1: return dispatch_n<__nv_bfloat16>(x, dt, b_in, c_out, al, hp,
                                                 y, he, B, S, D, N, st, sy,
                                                 ca, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
