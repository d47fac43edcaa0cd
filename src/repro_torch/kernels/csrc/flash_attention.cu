// Blockwise online-softmax attention for Hopper (sm_90a), GQA-aware.
//
//   q (B,S,H,D), k/v (B,T,Hkv,D), any strides with a unit stride on D;
//   out (B,S,H,D) contiguous, in q's type.  Query head h reads kv head
//   h / (H/Hkv) -- the mapping of jnp.repeat(k, H/Hkv, axis=2) -- and no
//   repeated copy of k or v is ever made.
//
//   s = (q . k) * scale            q, k, v cast to f32 BEFORE the dot;
//                                  scale = 1/sqrt(D) multiplied AFTER it
//   s = visible ? s : -1e30        a select, not an additive bias;
//                                  causal: k_pos <= q_pos, window > 0:
//                                  k_pos > q_pos - window, positions
//                                  absolute with q_pos = q_offset + row
//   m_new = max(m, max_j s_j),  p_j = exp(s_j - m_new),
//   corr = exp(m - m_new),  l = l*corr + sum p,  acc = acc*corr + p.v
//   out = acc / max(l, 1e-30)
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// _kernel / flash_attention (and the GQA wrapper of kernels/ops.py,
// which repeated k/v per group first).  That kernel walks a (BH, nq, nk)
// grid with the KV axis sequential and keeps (acc, m, l) in VMEM
// scratch between grid steps; here one block owns one (b, h, 64-row q
// tile) and loops over 64-key tiles of k/v staged in shared memory, the
// online-softmax state of each row kept in f32 registers.
//
// Design, and what bounds it.  Per visible key the work is 4*D flops
// (two dots of length D); the bytes are q, k, v and out read or written
// once.  At the serving path's shapes (hymba-1.5b: S=4096, window
// 1024, D=64) that is about 100 flops a byte, so the bound is
// operations.  This first kernel is scalar f32 on the CUDA cores (the
// reference's f32-before-the-dot numerics; no tensor cores): 256
// threads, four to a q row.  For the scores a thread holds its q row in
// registers and takes 16 of the tile's 64 keys, reading each key row as
// float4s (rows padded to D+4 floats, so the four lanes of a row hit
// four distinct banks); the 4-lane row max and row sum are shuffles;
// p goes through shared memory; for p.v a thread owns D/4 of the
// row's output columns, again as float4s.  Key tiles wholly outside
// every row's causal/window band are skipped -- except in a block that
// holds a row that sees no key at all: the reference gives such a row
// exp(-1e30 - (-1e30)) = 1 for every key, i.e. the mean of v over all
// T keys, so that block walks all T keys, as the reference's grid
// does.  Keys past T (a tail tile) get -inf and zero k/v, so they add
// nothing even to such a row.  expf, true division, no fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define FA_BQ 64
#define FA_BK 64
#define FA_THREADS 256
#define FA_NEG (-1e30f)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_as(float v, __nv_bfloat16* p) {
    *p = __float2bfloat16_rn(v);
}

template <int D>
__host__ __device__ constexpr int fa_smem_floats() {
    return FA_BK * (D + 4) + FA_BK * D + FA_BQ * (FA_BK + 4);
}

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int S, int T_len, int H, int Hkv,
                       long long q_sb, long long q_ss, long long q_sh,
                       long long k_sb, long long k_st, long long k_sh,
                       long long v_sb, long long v_st, long long v_sh,
                       int causal, int window, int q_offset, float scale) {
    constexpr int KS = D + 4;            // padded k row (floats)
    constexpr int PS = FA_BK + 4;        // padded p row (floats)
    constexpr int DG = D / 16;           // float4 output groups a thread
    extern __shared__ float4 fa_smem4[];
    float* Ks = reinterpret_cast<float*>(fa_smem4);   // [BK][KS]
    float* Vs = Ks + FA_BK * KS;                       // [BK][D]
    float* Ps = Vs + FA_BK * D;                        // [BQ][PS]
    __shared__ int range_lo, range_hi;

    const int tid = threadIdx.x;
    const int r = tid >> 2;              // the q row of the tile
    const int c = tid & 3;               // this thread's quarter of it
    const int q0 = blockIdx.x * FA_BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int hk = h / (H / Hkv);
    const int row = q0 + r;
    const bool row_ok = row < S;
    const int qp = q_offset + row;

    // the keys this block needs: the union of its rows' bands, or all
    // T when one of its rows sees none
    if (tid == 0) {
        int lo = T_len, hi = 0;
        bool empty = false;
        for (int rr = 0; rr < FA_BQ && q0 + rr < S; ++rr) {
            const int p = q_offset + q0 + rr;
            const int l = window > 0 ? max(0, p - window + 1) : 0;
            const int u = causal ? min(T_len, p + 1) : T_len;
            if (u <= l) { empty = true; break; }
            lo = min(lo, l);
            hi = max(hi, u);
        }
        range_lo = empty ? 0 : lo;
        range_hi = empty ? T_len : hi;
    }

    float qr[D];
    {
        const T* qrow = q + (long long)b * q_sb + (long long)row * q_ss
                        + (long long)h * q_sh;
#pragma unroll
        for (int d = 0; d < D; ++d) qr[d] = row_ok ? to_f32(qrow[d]) : 0.0f;
    }
    float m_run = FA_NEG, l_run = 0.0f;
    float4 acc[DG];
#pragma unroll
    for (int g = 0; g < DG; ++g) acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);

    __syncthreads();
    const int t_end = range_hi;
    const T* kbase = k + (long long)b * k_sb + (long long)hk * k_sh;
    const T* vbase = v + (long long)b * v_sb + (long long)hk * v_sh;
    for (int t0 = (range_lo / FA_BK) * FA_BK; t0 < t_end; t0 += FA_BK) {
        // stage the k/v tile in f32; keys past T are zeros
        for (int i = tid; i < FA_BK * D; i += FA_THREADS) {
            const int j = i / D, d = i % D;
            const int kk = t0 + j;
            float kv = 0.0f, vv = 0.0f;
            if (kk < T_len) {
                kv = to_f32(kbase[(long long)kk * k_st + d]);
                vv = to_f32(vbase[(long long)kk * v_st + d]);
            }
            Ks[j * KS + d] = kv;
            Vs[j * D + d] = vv;
        }
        __syncthreads();

        // scores of keys j = c + 4*i, i < 16
        float s[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) s[i] = 0.0f;
        const float4* K4 = reinterpret_cast<const float4*>(Ks);
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
            const float q_x = qr[4 * d4], q_y = qr[4 * d4 + 1],
                        q_z = qr[4 * d4 + 2], q_w = qr[4 * d4 + 3];
#pragma unroll
            for (int i = 0; i < 16; ++i) {
                const float4 kf = K4[(c + 4 * i) * (KS / 4) + d4];
                s[i] = fmaf(q_x, kf.x, s[i]);
                s[i] = fmaf(q_y, kf.y, s[i]);
                s[i] = fmaf(q_z, kf.z, s[i]);
                s[i] = fmaf(q_w, kf.w, s[i]);
            }
        }
        float tmax = -INFINITY;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const int kk = t0 + c + 4 * i;
            const bool real = kk < T_len;
            const bool vis = real && (!causal || kk <= qp)
                             && (window <= 0 || kk > qp - window);
            const float sc = s[i] * scale;
            s[i] = vis ? sc : (real ? FA_NEG : -INFINITY);
            tmax = fmaxf(tmax, s[i]);
        }
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        const float m_new = fmaxf(m_run, tmax);
        float psum = 0.0f;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const float p = expf(s[i] - m_new);
            psum += p;
            Ps[r * PS + c + 4 * i] = p;
        }
        psum += __shfl_xor_sync(0xffffffffu, psum, 1);
        psum += __shfl_xor_sync(0xffffffffu, psum, 2);
        const float corr = expf(m_run - m_new);
        l_run = l_run * corr + psum;
        m_run = m_new;
        __syncthreads();

        // acc = acc*corr + p.v over this thread's columns
        // 4*(c + 4*g) .. +3
#pragma unroll
        for (int g = 0; g < DG; ++g) {
            acc[g].x *= corr; acc[g].y *= corr;
            acc[g].z *= corr; acc[g].w *= corr;
        }
        const float4* P4 = reinterpret_cast<const float4*>(Ps + r * PS);
        const float4* V4 = reinterpret_cast<const float4*>(Vs);
#pragma unroll 4
        for (int j4 = 0; j4 < FA_BK / 4; ++j4) {
            const float4 p4 = P4[j4];
            const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int j = 4 * j4 + e;
#pragma unroll
                for (int g = 0; g < DG; ++g) {
                    const float4 vv = V4[j * (D / 4) + c + 4 * g];
                    acc[g].x = fmaf(pj[e], vv.x, acc[g].x);
                    acc[g].y = fmaf(pj[e], vv.y, acc[g].y);
                    acc[g].z = fmaf(pj[e], vv.z, acc[g].z);
                    acc[g].w = fmaf(pj[e], vv.w, acc[g].w);
                }
            }
        }
        __syncthreads();
    }

    if (row_ok) {
        const float l = fmaxf(l_run, 1e-30f);
        T* orow = out + (((long long)b * S + row) * H + h) * D;
#pragma unroll
        for (int g = 0; g < DG; ++g) {
            const int d = 4 * (c + 4 * g);
            store_as(acc[g].x / l, orow + d);
            store_as(acc[g].y / l, orow + d + 1);
            store_as(acc[g].z / l, orow + d + 2);
            store_as(acc[g].w / l, orow + d + 3);
        }
    }
}

template <typename T, int D>
static int launch_fa(const void* q, const void* k, const void* v, void* out,
                     int B, int S, int T_len, int H, int Hkv,
                     const long long* st, int causal, int window,
                     int q_offset, float scale, cudaStream_t stream) {
    const int smem = fa_smem_floats<D>() * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((S + FA_BQ - 1) / FA_BQ, H, B);
    flash_attention_kernel<T, D><<<grid, FA_THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), S, T_len, H, Hkv,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
        causal, window, q_offset, scale);
    return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_d(const void* q, const void* k, const void* v,
                      void* out, int B, int S, int T_len, int H, int Hkv,
                      int D, const long long* st, int causal, int window,
                      int q_offset, float scale, cudaStream_t s) {
    switch (D) {
        case 16: return launch_fa<T, 16>(q, k, v, out, B, S, T_len, H, Hkv,
                                         st, causal, window, q_offset,
                                         scale, s);
        case 32: return launch_fa<T, 32>(q, k, v, out, B, S, T_len, H, Hkv,
                                         st, causal, window, q_offset,
                                         scale, s);
        case 64: return launch_fa<T, 64>(q, k, v, out, B, S, T_len, H, Hkv,
                                         st, causal, window, q_offset,
                                         scale, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// q (B,S,H,D), k/v (B,T,Hkv,D) with element strides (batch, position,
// head) q_sb..v_sh and a unit stride on D; out (B,S,H,D) contiguous.
// dtype 0 = f32, 1 = bf16 (all four tensors); D in {16, 32, 64}: the
// models' 64 and the JAX kernel tests' 16 and 32.
// Returns cudaGetLastError() after the launch; does not synchronise.
extern "C" int flash_attention_fwd(
        const void* q, const void* k, const void* v, void* out, int dtype,
        int B, int S, int T_len, int H, int Hkv, int D,
        long long q_sb, long long q_ss, long long q_sh,
        long long k_sb, long long k_st, long long k_sh,
        long long v_sb, long long v_st, long long v_sh,
        int causal, int window, int q_offset, float scale, void* stream) {
    if (B < 1 || S < 1 || T_len < 1 || H < 1 || Hkv < 1 || H % Hkv != 0
            || B > 65535 || H > 65535 || q_offset < 0)
        return (int)cudaErrorInvalidValue;
    const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_st, k_sh,
                             v_sb, v_st, v_sh};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return dispatch_d<float>(q, k, v, out, B, S, T_len, H, Hkv,
                                         D, st, causal, window, q_offset,
                                         scale, s);
        case 1: return dispatch_d<__nv_bfloat16>(q, k, v, out, B, S, T_len,
                                                 H, Hkv, D, st, causal,
                                                 window, q_offset, scale, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
