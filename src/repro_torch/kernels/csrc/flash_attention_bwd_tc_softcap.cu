// K4's bf16 backward pair with a logit softcap: the CAP instantiations
// of flash_attention_bwd_tc.cu's two kernels (tc::fa_bwd_tc_dq_kernel<D,
// true>, tc::fa_bwd_tc_dkdv_kernel<D, true>) at every head dim, in a
// translation unit of their own that _build.py compiles beside
// flash_attention_bwd_tc.cu and links into its library, so that file's
// instantiations without a cap compile as they did.  It includes
// flash_attention_bwd_tc.cu with FB_TC_KERNELS_ONLY: the kernels and
// their launches, not the entry points, which call these for a softcap
// > 0.
//
//   t = tanh(s * scale / cap), P = 2^(cap log2 e * t - lse log2 e),
//   dS = P (dP - delta) (1 - t^2)
//
// with the bf16 forward's branch-free tanh and constants (fa_hopper.cuh:
// softcap_r, one ex2 and one rcp: t = 1 - 2r, 1 - t^2 = 4 r (1 - r)), so
// P is of the capped score the forward's lse summed
// (flash_attention_bwd_tc.cu's header says how each kernel forms it).

#define FB_TC_KERNELS_ONLY
#include "flash_attention_bwd_tc.cu"

int fb_tc_dq_softcap(const void* q, const void* k, const void* v,
                     const void* o, const void* o_lo, const void* dout,
                     const float* lse, float* delta, void* dq, int B, int S,
                     int T, int H, int Hkv, int causal, int window,
                     int q_offset, float scale, cudaStream_t stream,
                     float softcap, int D) {
#define TC_ARGS q, k, v, o, o_lo, dout, lse, delta, dq, B, S, T, H, Hkv, \
                causal, window, q_offset, scale, stream, softcap
    switch (D) {
        case 16: return tc::launch_dq<16, true>(TC_ARGS);
        case 32: return tc::launch_dq<32, true>(TC_ARGS);
        case 64: return tc::launch_dq<64, true>(TC_ARGS);
        case 80: return tc::launch_dq<80, true>(TC_ARGS);
        case 128: return tc::launch_dq<128, true>(TC_ARGS);
        case 192: return tc::launch_dq<192, true>(TC_ARGS);
    }
#undef TC_ARGS
    return (int)cudaErrorInvalidValue;
}

int fb_tc_dkdv_softcap(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int S,
                       int T, int H, int Hkv, int causal, int window,
                       int q_offset, float scale, cudaStream_t stream,
                       float softcap, int D) {
#define TC_ARGS q, k, v, dout, lse, delta, dk, dv, B, S, T, H, Hkv, causal, \
                window, q_offset, scale, stream, softcap
    switch (D) {
        case 16: return tc::launch_dkdv<16, true>(TC_ARGS);
        case 32: return tc::launch_dkdv<32, true>(TC_ARGS);
        case 64: return tc::launch_dkdv<64, true>(TC_ARGS);
        case 80: return tc::launch_dkdv<80, true>(TC_ARGS);
        case 128: return tc::launch_dkdv<128, true>(TC_ARGS);
        case 192: return tc::launch_dkdv<192, true>(TC_ARGS);
    }
#undef TC_ARGS
    return (int)cudaErrorInvalidValue;
}
