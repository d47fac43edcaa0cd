// K4's f32 backward pair with a logit softcap: the CAP instantiations
// of flash_attention_bwd.cu's two kernels (fa_bwd_dq_kernel<D, true>,
// fa_bwd_dkdv_kernel<D, true>) at every head dim, in a translation unit
// of their own that _build.py compiles beside flash_attention_bwd.cu
// and links into its library, so that file's instantiations without a
// cap compile as they did.  It includes flash_attention_bwd.cu with
// FB_KERNELS_ONLY: the kernels and their launches, not the entry
// points, which call these for a softcap > 0.
//
//   t = tanh(s / cap), c = cap * t, P = exp(c - lse),
//   dS = P * (dP - delta) * (1 - t^2)
//
// with the forward's tanhf (flash_attention.cu: fa_softcap), so P is of
// the capped score the forward's lse summed (flash_attention_bwd.cu's
// header says how each kernel forms it).

#define FB_KERNELS_ONLY
#include "flash_attention_bwd.cu"

int fb_dq_softcap(const float* q, const float* k, const float* v,
                  const float* o, const float* dout, const float* lse,
                  float* delta, float* dq, int B, int S, int T_len, int H,
                  int Hkv, int causal, int window, int q_offset, float scale,
                  cudaStream_t stream, float cap, int D) {
#define FB_ARGS q, k, v, o, dout, lse, delta, dq, B, S, T_len, H, Hkv, \
                causal, window, q_offset, scale, stream, cap
    switch (D) {
        case 16: return launch_dq<16, true>(FB_ARGS);
        case 32: return launch_dq<32, true>(FB_ARGS);
        case 64: return launch_dq<64, true>(FB_ARGS);
        case 80: return launch_dq<80, true>(FB_ARGS);
        case 128: return launch_dq<128, true>(FB_ARGS);
        case 192: return launch_dq<192, true>(FB_ARGS);
    }
#undef FB_ARGS
    return (int)cudaErrorInvalidValue;
}

int fb_dkdv_softcap(const float* q, const float* k, const float* v,
                    const float* dout, const float* lse, const float* delta,
                    float* dk, float* dv, int B, int S, int T_len, int H,
                    int Hkv, int causal, int window, int q_offset,
                    float scale, cudaStream_t stream, float cap, int D) {
#define FB_ARGS q, k, v, dout, lse, delta, dk, dv, B, S, T_len, H, Hkv, \
                causal, window, q_offset, scale, stream, cap
    switch (D) {
        case 16: return launch_dkdv<16, true>(FB_ARGS);
        case 32: return launch_dkdv<32, true>(FB_ARGS);
        case 64: return launch_dkdv<64, true>(FB_ARGS);
        case 80: return launch_dkdv<80, true>(FB_ARGS);
        case 128: return launch_dkdv<128, true>(FB_ARGS);
        case 192: return launch_dkdv<192, true>(FB_ARGS);
    }
#undef FB_ARGS
    return (int)cudaErrorInvalidValue;
}
