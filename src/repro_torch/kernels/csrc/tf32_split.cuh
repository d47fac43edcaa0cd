// The split of an f32 operand into two TF32 values, shared by every f32
// product of K4: the forward's S and P.V (flash_attention.cu, with and
// without lse and a cap) and the backward pair's S, dP and gradient
// products (flash_attention_bwd.cu).  The pair recomputes S from the
// same split as the forward that summed lse, so P = exp(S - lse) sees
// the forward's rounding and not a second one.
//
//   x = hi + lo + r,  hi = x rounded to TF32,  lo = (x - hi) rounded to
//   TF32,  |r| <= 2^-22 |x|
//
// a . b is then taken as lo.hi + hi.lo + hi.hi on the tensor cores, the
// TF32 products exact in f32 (lo.lo, at most 2^-22 of a.b, dropped).
// Both cuts round to nearest (ties away from zero) by an integer add of
// half a TF32 ulp before the mask, so the parts' errors take either sign
// and average out over a dot.  The first split of these kernels cleared the
// 13 low bits of hi and passed lo whole to be truncated by the product:
// both cuts toward zero, so the dropped part had the sign of each term.
// The split is one half of the repair of scores built of large terms;
// the score products' sums are the other (tf32_mma.cuh: score_step: the
// tensor cores round a chained sum toward zero at the running sum's
// magnitude).  With both, the forward on q x 100 reads 0.5-0.85x its
// f32 twin's max abs distance from an f64 answer at llama's serving
// layer and at most 1.37x on the small cases chip_smoke.py gates; with
// either alone, up to 5.8-6.6x in max abs (PERF.md).  cvt.rna.tf32.f32
// rounds the same way but compiles to a compare and select around each
// rounding on sm_90 (variant rna: 9-22 % slower).  hi rounded and lo
// passed whole (rnahi: 10-14 % faster) leaves up to 2^-21 |x| of x, twice
// the bound above.
//
// Non-finite x: the add carries into the exponent, never past it, for
// every finite x (a value within half an ulp of FLT_MAX rounds to inf,
// as round-to-nearest does).  +-inf keeps its bits in hi (the add falls
// in the bits the mask clears) and lo = inf - inf is NaN, so every
// product with an inf operand is NaN, as the first split made it; the
// f32 product would be +-inf or NaN, and a row with an infinite score is
// NaN in the twin's softmax either way.  A NaN's hi may lose its
// mantissa to the add (a mantissa of 1s carries into the sign: 0x7fffffff,
// the card's NaN, becomes -0), but lo = x - hi is then the card's NaN,
// which the clamp before lo's add keeps a NaN (0x7fffe000): the NaN
// reaches every product that x enters.  Masked scores are the finite
// -1e30 and never meet an infinity here.

#pragma once

#include <stdint.h>

__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    const int rest = __float_as_int(x - __uint_as_float(hi));
    lo = ((uint32_t)min(rest, 0x7fffefff) + 0x1000u) & 0xffffe000u;
}
