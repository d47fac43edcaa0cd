// K4's forwards with a logit softcap: the CAP instantiations of
// flash_attention.cu's two kernels (fa_fwd_f32_kernel<D, true, true>,
// flash_attention_tc_kernel<D, true, true>) at every head dim, in a
// translation unit of their own that _build.py compiles beside
// flash_attention.cu and links into its library, so that file's
// instantiations without a cap compile as they did.  One instantiation
// serves and trains: it writes lse (and, bf16, out_lo) where the caller
// passes them (training) and skips those stores where it passes null
// (serving), a branch in the epilogue only, so a cap costs one more
// kernel a head dim and dtype, not two.  It includes flash_attention.cu with FA_KERNELS_ONLY: the
// kernels and their launches, not the entry points.
//
//   s = (q . k) * scale,  s = cap * tanh(s / cap),  then the masks and
//   the online softmax of flash_attention.cu
//
// (the reference's models/attention.py: _softcap; its Pallas kernel has
// no softcap).  The f32 kernel caps each visible score where it is
// scaled, with the accurate tanhf (fa_softcap says why); the bf16
// kernel's softmax_tile caps every score of a tile, an interior tile's
// too, straight into the log2 domain with fa_hopper.cuh's branch-free
// softcap_r (one ex2 and one rcp, within ~2^-21 of tanh).  With lse,
// each row's log-sum-exp is that of its capped scores, in natural units
// as without a cap, and (bf16) out_lo is written as without one: the
// backward pairs' CAP instantiations (flash_attention_bwd_softcap.cu,
// flash_attention_bwd_tc_softcap.cu) recompute P from it with the same
// tanh as their forward's (f32: tanhf; bf16: softcap_r).

#define FA_KERNELS_ONLY
#include "flash_attention.cu"

int fa_fwd_softcap(const void* q, const void* k, const void* v, void* out,
                   int dtype, int B, int S, int T_len, int H, int Hkv, int D,
                   const long long* st, int causal, int window, int q_offset,
                   float scale, cudaStream_t stream, float softcap,
                   float* lse, void* out_lo) {
#define FA_ARGS q, k, v, out, B, S, T_len, H, Hkv, st, causal, window, \
                q_offset, scale, stream
    if (dtype == 0) {
        switch (D) {
            case 16: return launch_f32<16, true>(FA_ARGS, lse, softcap);
            case 32: return launch_f32<32, true>(FA_ARGS, lse, softcap);
            case 64: return launch_f32<64, true>(FA_ARGS, lse, softcap);
            case 80: return launch_f32<80, true>(FA_ARGS, lse, softcap);
            case 128: return launch_f32<128, true>(FA_ARGS, lse, softcap);
            case 192: return launch_f32<192, true>(FA_ARGS, lse, softcap);
        }
    } else if (dtype == 1) {
        switch (D) {
            case 16: return tc::launch<16, true>(FA_ARGS, lse, out_lo,
                                                 softcap);
            case 32: return tc::launch<32, true>(FA_ARGS, lse, out_lo,
                                                 softcap);
            case 64: return tc::launch<64, true>(FA_ARGS, lse, out_lo,
                                                 softcap);
            case 80: return tc::launch<80, true>(FA_ARGS, lse, out_lo,
                                                 softcap);
            case 128: return tc::launch<128, true>(FA_ARGS, lse, out_lo,
                                                   softcap);
            case 192: return tc::launch<192, true>(FA_ARGS, lse, out_lo,
                                                   softcap);
        }
    }
#undef FA_ARGS
    return (int)cudaErrorInvalidValue;
}
