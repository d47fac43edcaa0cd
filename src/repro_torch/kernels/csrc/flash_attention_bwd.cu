// The f32 backward of K4, the GQA online-softmax attention of
// flash_attention.cu, for Hopper (sm_90a): two kernels on the CUDA cores.
//
// The JAX package has no backward Pallas kernel: JAX differentiates the
// jnp attention and its training never calls src/repro/kernels/
// flash_attention.py: _kernel.  The port routes every CUDA tensor to its
// forward kernel, so a gradient through that kernel needs these.  They
// are the f32 counterpart of the forward's scalar kernel; the bf16
// tensor-core backward is a later item (ROADMAP, queue 2).
//
//   q, o, dO (B,S,H,D), k, v (B,T,Hkv,D), all contiguous f32; lse
//   (B,H,S) f32 from the forward (m + log(max(l, 1e-30)) of each row).
//   Query head h reads kv head h / (H/Hkv), as in the forward.
//
//   s_ij   = (q_i . k_j) * scale, visible by the forward's masks
//   P_ij   = exp(s_ij - lse_i) if visible, else 0
//   delta_i = sum_d dO_id * o_id
//   dS_ij  = P_ij * (dO_i . v_j - delta_i)
//   dq_i   = scale * sum_j dS_ij k_j
//   dk_j   = scale * sum_{h in group} sum_i dS_ij q_i
//   dv_j   = sum_{h in group} sum_i P_ij dO_i
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
//     head, b).  It computes delta for its rows itself and writes it to
//     a (B,H,S) buffer, then loops over the key tiles its rows can see
//     (rows that see no key take none), recomputes P from lse, and
//     writes dq once.  Launched first.
//   flash_attention_bwd_dkdv_f32: one block per (key tile of 64 keys,
//     kv head, b).  It loops over the q tiles that can see the tile (or
//     hold a row that sees no key) and, inside, over the kv head's group
//     of q heads, reads delta from the first kernel, recomputes P and
//     dS, and sums dk and dv over the group in registers: written once.
// Layout of both, as the forward's scalar kernel: 256 threads, four to
// a row of the stationary tile (a q row in the dq kernel, a key in the
// dkdv kernel), that row's two D-vectors in registers; the moving tile
// staged in shared memory as f32 rows padded to D+4 floats and read as
// float4 (broadcast across the 8 rows of a warp); the 64 x 64 tile of P
// or dS through shared memory; for the products a thread owns D/4 of
// its row's output columns.
//
// Bound: per visible (q, k) pair of a head, 10*D f32 flops (q.k,
// dO.v, dS.k, dS.q, P.dO: five dots of D) and one exp, on the CUDA
// cores (67e12 f32 flop/s); the bytes (q, k, v, o, dO read, dq, dk,
// dv written) are far below.  This design recomputes the scores in
// both kernels, 14*D a pair.

#include <cuda_runtime.h>
#include <math.h>

#define FB_BQ 64
#define FB_BK 64
#define FB_THREADS 256

// The keys absolute position p sees: [lo, hi) (empty when hi <= lo).
__device__ __forceinline__ void fb_band(int p, int T_len, int causal,
                                        int window, int& lo, int& hi) {
    lo = window > 0 ? max(0, p - window + 1) : 0;
    hi = causal ? min(T_len, p + 1) : T_len;
}

template <int D>
__host__ __device__ constexpr int fb_dq_smem_floats() {
    return 2 * FB_BK * (D + 4) + FB_BQ * (FB_BK + 4);
}

template <int D>
__host__ __device__ constexpr int fb_dkdv_smem_floats() {
    return 2 * FB_BQ * (D + 4) + 2 * FB_BK * (FB_BQ + 4) + 2 * FB_BQ;
}

template <int D>
__global__ void __launch_bounds__(FB_THREADS)
fa_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ o,
                 const float* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ delta,
                 float* __restrict__ dq, int S, int T_len, int H, int Hkv,
                 int causal, int window, int q_offset, float scale) {
    constexpr int KS = D + 4;
    constexpr int PS = FB_BK + 4;
    constexpr int DG = D / 16;
    extern __shared__ float4 fb_smem4[];
    float* Ks = reinterpret_cast<float*>(fb_smem4);   // [BK][KS]
    float* Vs = Ks + FB_BK * KS;                       // [BK][KS]
    float* Ps = Vs + FB_BK * KS;                       // [BQ][PS]: dS
    __shared__ int range_lo, range_hi;

    const int tid = threadIdx.x;
    const int r = tid >> 2;
    const int c = tid & 3;
    const int q0 = blockIdx.x * FB_BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int hk = h / (H / Hkv);
    const int row = q0 + r;
    const bool row_ok = row < S;
    int lo, hi;
    fb_band(q_offset + row, T_len, causal, window, lo, hi);
    const bool sees = row_ok && hi > lo;

    // the keys the block's rows see (rows that see none take no keys)
    if (tid == 0) {
        int l0 = T_len, h0 = 0;
        for (int rr = 0; rr < FB_BQ && q0 + rr < S; ++rr) {
            int l, u;
            fb_band(q_offset + q0 + rr, T_len, causal, window, l, u);
            if (u > l) {
                l0 = min(l0, l);
                h0 = max(h0, u);
            }
        }
        range_lo = l0;
        range_hi = h0;
    }

    const long long qoff = (((long long)b * S + row) * H + h) * D;
    float qr[D], dor[D];
    float dl = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
        qr[d] = row_ok ? q[qoff + d] : 0.0f;
        dor[d] = row_ok ? dout[qoff + d] : 0.0f;
        dl = fmaf(dor[d], row_ok ? o[qoff + d] : 0.0f, dl);
    }
    const long long rs = ((long long)b * H + h) * S + row;
    if (row_ok && c == 0) delta[rs] = dl;
    const float lse_r = row_ok ? lse[rs] : 0.0f;

    float4 acc[DG];
#pragma unroll
    for (int g = 0; g < DG; ++g) acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);

    __syncthreads();
    const float* kbase = k + ((long long)b * T_len * Hkv + hk) * D;
    const float* vbase = v + ((long long)b * T_len * Hkv + hk) * D;
    const long long kstride = (long long)Hkv * D;
    for (int t0 = (range_lo / FB_BK) * FB_BK; t0 < range_hi; t0 += FB_BK) {
        for (int i = tid; i < FB_BK * D; i += FB_THREADS) {
            const int j = i / D, d = i % D;
            const int kk = t0 + j;
            float kv = 0.0f, vv = 0.0f;
            if (kk < T_len) {
                kv = kbase[(long long)kk * kstride + d];
                vv = vbase[(long long)kk * kstride + d];
            }
            Ks[j * KS + d] = kv;
            Vs[j * KS + d] = vv;
        }
        __syncthreads();

        // scores and dO.v of keys j = c + 4*i, i < 16
        float s[16], dp[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) { s[i] = 0.0f; dp[i] = 0.0f; }
        const float4* K4 = reinterpret_cast<const float4*>(Ks);
        const float4* V4 = reinterpret_cast<const float4*>(Vs);
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
#pragma unroll
            for (int i = 0; i < 16; ++i) {
                const float4 kf = K4[(c + 4 * i) * (KS / 4) + d4];
                const float4 vf = V4[(c + 4 * i) * (KS / 4) + d4];
                s[i] = fmaf(qr[4 * d4], kf.x, s[i]);
                s[i] = fmaf(qr[4 * d4 + 1], kf.y, s[i]);
                s[i] = fmaf(qr[4 * d4 + 2], kf.z, s[i]);
                s[i] = fmaf(qr[4 * d4 + 3], kf.w, s[i]);
                dp[i] = fmaf(dor[4 * d4], vf.x, dp[i]);
                dp[i] = fmaf(dor[4 * d4 + 1], vf.y, dp[i]);
                dp[i] = fmaf(dor[4 * d4 + 2], vf.z, dp[i]);
                dp[i] = fmaf(dor[4 * d4 + 3], vf.w, dp[i]);
            }
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const int kk = t0 + c + 4 * i;
            const bool vis = sees && kk >= lo && kk < hi;
            const float p = vis ? expf(s[i] * scale - lse_r) : 0.0f;
            Ps[r * PS + c + 4 * i] = p * (dp[i] - dl);
        }
        __syncthreads();

        // acc += dS . K over this thread's columns 4*(c + 4*g) .. +3
        const float4* P4 = reinterpret_cast<const float4*>(Ps + r * PS);
#pragma unroll 4
        for (int j4 = 0; j4 < FB_BK / 4; ++j4) {
            const float4 p4 = P4[j4];
            const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int j = 4 * j4 + e;
#pragma unroll
                for (int g = 0; g < DG; ++g) {
                    const float4 kf = K4[j * (KS / 4) + c + 4 * g];
                    acc[g].x = fmaf(pj[e], kf.x, acc[g].x);
                    acc[g].y = fmaf(pj[e], kf.y, acc[g].y);
                    acc[g].z = fmaf(pj[e], kf.z, acc[g].z);
                    acc[g].w = fmaf(pj[e], kf.w, acc[g].w);
                }
            }
        }
        __syncthreads();
    }

    if (row_ok) {
        float* out = dq + qoff;
#pragma unroll
        for (int g = 0; g < DG; ++g) {
            const int d = 4 * (c + 4 * g);
            out[d] = acc[g].x * scale;
            out[d + 1] = acc[g].y * scale;
            out[d + 2] = acc[g].z * scale;
            out[d + 3] = acc[g].w * scale;
        }
    }
}

template <int D>
__global__ void __launch_bounds__(FB_THREADS)
fa_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int S, int T_len, int H, int Hkv,
                   int causal, int window, int q_offset, float scale) {
    constexpr int QS = D + 4;            // padded q / dO row (floats)
    constexpr int PS = FB_BQ + 4;        // padded P / dS row (floats)
    constexpr int DG = D / 16;
    extern __shared__ float4 fb_smem4[];
    float* Qs = reinterpret_cast<float*>(fb_smem4);   // [BQ][QS]
    float* Ds = Qs + FB_BQ * QS;                       // [BQ][QS]: dO
    float* Ps = Ds + FB_BQ * QS;                       // [BK][PS]: P
    float* Ss = Ps + FB_BK * PS;                       // [BK][PS]: dS
    float* lse_s = Ss + FB_BK * PS;                    // [BQ]
    float* dl_s = lse_s + FB_BQ;                       // [BQ]

    const int tid = threadIdx.x;
    const int j = tid >> 2;              // the key of the tile
    const int c = tid & 3;
    const int k0 = blockIdx.x * FB_BK;
    const int hk = blockIdx.y;
    const int b = blockIdx.z;
    const int rep = H / Hkv;
    const int kk = k0 + j;
    const bool key_ok = kk < T_len;
    const int k1 = min(T_len, k0 + FB_BK);
    const float inv_t = 1.0f / (float)T_len;

    const long long koff = (((long long)b * T_len + kk) * Hkv + hk) * D;
    float kr[D], vr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
        kr[d] = key_ok ? k[koff + d] : 0.0f;
        vr[d] = key_ok ? v[koff + d] : 0.0f;
    }
    float4 dka[DG], dva[DG];
#pragma unroll
    for (int g = 0; g < DG; ++g) {
        dka[g] = make_float4(0.f, 0.f, 0.f, 0.f);
        dva[g] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

    const int n_qt = (S + FB_BQ - 1) / FB_BQ;
    for (int qt = 0; qt < n_qt; ++qt) {
        const int r0 = qt * FB_BQ;
        // does a row of this q tile see a key of this tile, or none at
        // all (then it sees every key at 1/T)?
        int pred = 0;
        if (tid < FB_BQ && r0 + tid < S) {
            int lo, hi;
            fb_band(q_offset + r0 + tid, T_len, causal, window, lo, hi);
            pred = hi <= lo || (lo < k1 && hi > k0);
        }
        if (!__syncthreads_or(pred)) continue;
        for (int hh = 0; hh < rep; ++hh) {
            const int h = hk * rep + hh;
            for (int i = tid; i < FB_BQ * D; i += FB_THREADS) {
                const int r = i / D, d = i % D;
                const int row = r0 + r;
                float qv = 0.0f, dv_ = 0.0f;
                if (row < S) {
                    const long long off =
                        (((long long)b * S + row) * H + h) * D + d;
                    qv = q[off];
                    dv_ = dout[off];
                }
                Qs[r * QS + d] = qv;
                Ds[r * QS + d] = dv_;
            }
            if (tid < FB_BQ) {
                const int row = r0 + tid;
                const long long rs = ((long long)b * H + h) * S + row;
                lse_s[tid] = row < S ? lse[rs] : 0.0f;
                dl_s[tid] = row < S ? delta[rs] : 0.0f;
            }
            __syncthreads();

            // scores and dO.v of rows i = c + 4*ii, ii < 16
            float s[16], dp[16];
#pragma unroll
            for (int ii = 0; ii < 16; ++ii) { s[ii] = 0.0f; dp[ii] = 0.0f; }
            const float4* Q4 = reinterpret_cast<const float4*>(Qs);
            const float4* D4 = reinterpret_cast<const float4*>(Ds);
#pragma unroll
            for (int d4 = 0; d4 < D / 4; ++d4) {
#pragma unroll
                for (int ii = 0; ii < 16; ++ii) {
                    const float4 qf = Q4[(c + 4 * ii) * (QS / 4) + d4];
                    const float4 df = D4[(c + 4 * ii) * (QS / 4) + d4];
                    s[ii] = fmaf(qf.x, kr[4 * d4], s[ii]);
                    s[ii] = fmaf(qf.y, kr[4 * d4 + 1], s[ii]);
                    s[ii] = fmaf(qf.z, kr[4 * d4 + 2], s[ii]);
                    s[ii] = fmaf(qf.w, kr[4 * d4 + 3], s[ii]);
                    dp[ii] = fmaf(df.x, vr[4 * d4], dp[ii]);
                    dp[ii] = fmaf(df.y, vr[4 * d4 + 1], dp[ii]);
                    dp[ii] = fmaf(df.z, vr[4 * d4 + 2], dp[ii]);
                    dp[ii] = fmaf(df.w, vr[4 * d4 + 3], dp[ii]);
                }
            }
#pragma unroll
            for (int ii = 0; ii < 16; ++ii) {
                const int i = c + 4 * ii;
                const int row = r0 + i;
                int lo, hi;
                fb_band(q_offset + row, T_len, causal, window, lo, hi);
                const bool in = key_ok && row < S;
                const bool empty = hi <= lo;
                const bool vis = kk >= lo && kk < hi;
                float p = 0.0f, ds = 0.0f;
                if (in && empty) {
                    p = inv_t;
                } else if (in && vis) {
                    p = expf(s[ii] * scale - lse_s[i]);
                    ds = p * (dp[ii] - dl_s[i]);
                }
                Ps[j * PS + i] = p;
                Ss[j * PS + i] = ds;
            }
            __syncwarp();      // a key's four threads share one warp

            // dv += P . dO, dk += dS . q over columns 4*(c + 4*g) .. +3
            const float4* P4 = reinterpret_cast<const float4*>(Ps + j * PS);
            const float4* S4 = reinterpret_cast<const float4*>(Ss + j * PS);
#pragma unroll 2
            for (int i4 = 0; i4 < FB_BQ / 4; ++i4) {
                const float4 p4 = P4[i4];
                const float4 s4 = S4[i4];
                const float pi[4] = {p4.x, p4.y, p4.z, p4.w};
                const float si[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int i = 4 * i4 + e;
#pragma unroll
                    for (int g = 0; g < DG; ++g) {
                        const float4 df = D4[i * (QS / 4) + c + 4 * g];
                        const float4 qf = Q4[i * (QS / 4) + c + 4 * g];
                        dva[g].x = fmaf(pi[e], df.x, dva[g].x);
                        dva[g].y = fmaf(pi[e], df.y, dva[g].y);
                        dva[g].z = fmaf(pi[e], df.z, dva[g].z);
                        dva[g].w = fmaf(pi[e], df.w, dva[g].w);
                        dka[g].x = fmaf(si[e], qf.x, dka[g].x);
                        dka[g].y = fmaf(si[e], qf.y, dka[g].y);
                        dka[g].z = fmaf(si[e], qf.z, dka[g].z);
                        dka[g].w = fmaf(si[e], qf.w, dka[g].w);
                    }
                }
            }
            __syncthreads();   // before the next staging overwrites Qs
        }
    }

    if (key_ok) {
#pragma unroll
        for (int g = 0; g < DG; ++g) {
            const int d = 4 * (c + 4 * g);
            dk[koff + d] = dka[g].x * scale;
            dk[koff + d + 1] = dka[g].y * scale;
            dk[koff + d + 2] = dka[g].z * scale;
            dk[koff + d + 3] = dka[g].w * scale;
            dv[koff + d] = dva[g].x;
            dv[koff + d + 1] = dva[g].y;
            dv[koff + d + 2] = dva[g].z;
            dv[koff + d + 3] = dva[g].w;
        }
    }
}

template <int D>
static int launch_dq(const float* q, const float* k, const float* v,
                     const float* o, const float* dout, const float* lse,
                     float* delta, float* dq, int B, int S, int T_len, int H,
                     int Hkv, int causal, int window, int q_offset,
                     float scale, cudaStream_t stream) {
    const int smem = fb_dq_smem_floats<D>() * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        fa_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((S + FB_BQ - 1) / FB_BQ, H, B);
    fa_bwd_dq_kernel<D><<<grid, FB_THREADS, smem, stream>>>(
        q, k, v, o, dout, lse, delta, dq, S, T_len, H, Hkv, causal, window,
        q_offset, scale);
    return (int)cudaGetLastError();
}

template <int D>
static int launch_dkdv(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse,
                       const float* delta, float* dk, float* dv, int B,
                       int S, int T_len, int H, int Hkv, int causal,
                       int window, int q_offset, float scale,
                       cudaStream_t stream) {
    const int smem = fb_dkdv_smem_floats<D>() * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        fa_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((T_len + FB_BK - 1) / FB_BK, Hkv, B);
    fa_bwd_dkdv_kernel<D><<<grid, FB_THREADS, smem, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, S, T_len, H, Hkv, causal, window,
        q_offset, scale);
    return (int)cudaGetLastError();
}

static bool fb_shape_ok(int B, int S, int T_len, int H, int Hkv,
                        int q_offset) {
    return B >= 1 && S >= 1 && T_len >= 1 && H >= 1 && Hkv >= 1
           && H % Hkv == 0 && B <= 65535 && H <= 65535 && q_offset >= 0;
}

// q, o, dout, dq (B,S,H,D), k, v (B,T,Hkv,D), lse and delta (B,H,S), all
// contiguous f32; D in {16, 32, 64}.  Writes dq and delta = rowsum(dout
// * o).  Returns cudaGetLastError() after the launch; does not
// synchronise.
extern "C" int flash_attention_bwd_dq_f32(
        const void* q, const void* k, const void* v, const void* o,
        const void* dout, const void* lse, void* delta, void* dq, int B,
        int S, int T_len, int H, int Hkv, int D, int causal, int window,
        int q_offset, float scale, void* stream) {
    if (!fb_shape_ok(B, S, T_len, H, Hkv, q_offset))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FB_DQ_ARGS static_cast<const float*>(q), static_cast<const float*>(k), \
    static_cast<const float*>(v), static_cast<const float*>(o), \
    static_cast<const float*>(dout), static_cast<const float*>(lse), \
    static_cast<float*>(delta), static_cast<float*>(dq), B, S, T_len, H, \
    Hkv, causal, window, q_offset, scale, s
    switch (D) {
        case 16: return launch_dq<16>(FB_DQ_ARGS);
        case 32: return launch_dq<32>(FB_DQ_ARGS);
        case 64: return launch_dq<64>(FB_DQ_ARGS);
    }
#undef FB_DQ_ARGS
    return (int)cudaErrorInvalidValue;
}

// q, dout (B,S,H,D), k, v, dk, dv (B,T,Hkv,D), lse and delta (B,H,S) --
// delta as flash_attention_bwd_dq_f32 wrote it, so launched after it on
// the same stream -- all contiguous f32; D in {16, 32, 64}.  Writes dk
// and dv, each summed over the kv head's group of q heads.
extern "C" int flash_attention_bwd_dkdv_f32(
        const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv, int B,
        int S, int T_len, int H, int Hkv, int D, int causal, int window,
        int q_offset, float scale, void* stream) {
    if (!fb_shape_ok(B, S, T_len, H, Hkv, q_offset))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FB_KV_ARGS static_cast<const float*>(q), static_cast<const float*>(k), \
    static_cast<const float*>(v), static_cast<const float*>(dout), \
    static_cast<const float*>(lse), static_cast<const float*>(delta), \
    static_cast<float*>(dk), static_cast<float*>(dv), B, S, T_len, H, Hkv, \
    causal, window, q_offset, scale, s
    switch (D) {
        case 16: return launch_dkdv<16>(FB_KV_ARGS);
        case 32: return launch_dkdv<32>(FB_KV_ARGS);
        case 64: return launch_dkdv<64>(FB_KV_ARGS);
    }
#undef FB_KV_ARGS
    return (int)cudaErrorInvalidValue;
}
