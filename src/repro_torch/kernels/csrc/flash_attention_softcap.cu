// K4's serving forwards with a logit softcap: the CAP instantiations of
// flash_attention.cu's two kernels (fa_fwd_f32_kernel<D, false, true>,
// flash_attention_tc_kernel<D, false, true>) at every head dim, in a
// translation unit of their own that _build.py compiles beside
// flash_attention.cu and links into its library, so that file's
// instantiations without a cap compile as they did.  It includes
// flash_attention.cu with FA_KERNELS_ONLY: the kernels and their
// launches, not the entry points.
//
//   s = (q . k) * scale,  s = cap * tanh(s / cap),  then the masks and
//   the online softmax of flash_attention.cu
//
// (the reference's models/attention.py: _softcap; its Pallas kernel has
// no softcap).  The f32 kernel caps each visible score where it is
// scaled; the bf16 kernel's softmax_tile caps every score of a tile, an
// interior tile's too, in natural units and then takes it to the log2
// domain.  tanhf is the accurate one: fa_softcap says why.  Only without
// lse: the training kernels with a cap are ROADMAP queue 1 item 18.

#define FA_KERNELS_ONLY
#include "flash_attention.cu"

int fa_fwd_softcap(const void* q, const void* k, const void* v, void* out,
                   int dtype, int B, int S, int T_len, int H, int Hkv, int D,
                   const long long* st, int causal, int window, int q_offset,
                   float scale, cudaStream_t stream, float softcap) {
#define FA_ARGS q, k, v, out, B, S, T_len, H, Hkv, st, causal, window, \
                q_offset, scale, stream
    if (dtype == 0) {
        switch (D) {
            case 16: return launch_f32<16, true>(FA_ARGS, nullptr, softcap);
            case 32: return launch_f32<32, true>(FA_ARGS, nullptr, softcap);
            case 64: return launch_f32<64, true>(FA_ARGS, nullptr, softcap);
            case 80: return launch_f32<80, true>(FA_ARGS, nullptr, softcap);
            case 128: return launch_f32<128, true>(FA_ARGS, nullptr, softcap);
            case 192: return launch_f32<192, true>(FA_ARGS, nullptr, softcap);
        }
    } else if (dtype == 1) {
        switch (D) {
            case 16: return tc::launch<16, true>(FA_ARGS, nullptr, nullptr,
                                                 softcap);
            case 32: return tc::launch<32, true>(FA_ARGS, nullptr, nullptr,
                                                 softcap);
            case 64: return tc::launch<64, true>(FA_ARGS, nullptr, nullptr,
                                                 softcap);
            case 80: return tc::launch<80, true>(FA_ARGS, nullptr, nullptr,
                                                 softcap);
            case 128: return tc::launch<128, true>(FA_ARGS, nullptr, nullptr,
                                                   softcap);
            case 192: return tc::launch<192, true>(FA_ARGS, nullptr, nullptr,
                                                   softcap);
        }
    }
#undef FA_ARGS
    return (int)cudaErrorInvalidValue;
}
