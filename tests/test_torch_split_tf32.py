"""K4's f32 split into two TF32 values (``csrc/tf32_split.cuh``), modelled
by ``split_tf32_plain`` and ``split_dot_plain``: both parts are TF32
values rounded to nearest, the split leaves at most 2^-22 of x with an
error of either sign, special values come through as the kernels need
them, and on scores built of large terms (q x 100 at llama's head dim)
the rounded split's product lies as close to the exact answer as an f32
matmul, where the first split (both cuts toward zero) does not.  Then
``chip_smoke.check_against_f64``'s gate beside the f64 one: the kernel's
distance from the f64 answer against its twin's, in root mean square on
every case and in max abs on a large one.

Distances are Frobenius norms over the whole block: a max over 4,096
entries swings by half between seeds, the norm by a few percent."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa

CSRC = Path(fa.__file__).resolve().parent / "csrc"
TF32_LOW_BITS = 0x1FFF
BINADES = (2.0 ** -40, 2.0 ** -10, 1.0, 100.0, 2.0 ** 30)


def _normal(seed, n, scale):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(n) * scale)
                            .astype(np.float32))


def _truncating_split(x):
    """The first split of the f32 kernels: hi = x with its 13 low bits
    cleared, lo = x - hi as the TF32 product reads it (truncated)."""
    hi = fa._from_bits(fa._bits(x) & 0xFFFFE000)
    return hi, fa._from_bits(fa._bits(x - hi) & 0xFFFFE000)


@pytest.mark.parametrize("scale", BINADES)
def test_both_parts_are_tf32_values(scale):
    hi, lo = fa.split_tf32_plain(_normal(1, 50_000, scale))
    for part in (hi, lo):
        assert int((fa._bits(part) & TF32_LOW_BITS).max()) == 0


@pytest.mark.parametrize("scale", BINADES)
def test_split_leaves_at_most_2_pow_minus_22_of_x(scale):
    x = _normal(2, 50_000, scale)
    hi, lo = fa.split_tf32_plain(x)
    rest = (x.double() - hi.double() - lo.double()).abs()
    assert bool((rest <= 2.0 ** -22 * x.double().abs()).all())
    # hi alone is x rounded to nearest: within half a TF32 ulp
    assert bool(((x.double() - hi.double()).abs()
                 <= 2.0 ** -11 * x.double().abs()).all())


@pytest.mark.parametrize("scale", (2.0 ** -10, 1.0, 2.0 ** 20))
def test_signed_error_averages_out_where_the_truncating_split_does_not(
        scale):
    """The relative error (x - hi - lo) / x over 100,000 normal draws:
    the rounded split's mean lies within 4 standard errors of zero; the
    truncating split's error has the sign of x at every draw, its mean
    more than 100 standard errors away."""
    x = _normal(3, 100_000, scale).double()
    for split, near_zero in ((fa.split_tf32_plain, True),
                             (_truncating_split, False)):
        hi, lo = split(x.float())
        e = (x - hi.double() - lo.double()) / x
        z = abs(float(e.mean() / e.std())) * len(e) ** 0.5
        assert (z < 4.0) if near_zero else (z > 100.0), (split, z)


def test_zeros_infinities_and_nans_come_through():
    """+-0 split into (+-0, +0); +-inf keeps its bits in hi and lo is a
    NaN (every product with an inf operand is NaN); any NaN, the card's
    0x7fffffff and a negative one among them, leaves a NaN in lo, so it
    reaches every product it enters."""
    signed_zero = torch.tensor([0.0, -0.0])
    hi, lo = fa.split_tf32_plain(signed_zero)
    assert torch.equal(fa._bits(hi), fa._bits(signed_zero))
    assert torch.equal(lo, torch.zeros(2)) and not bool(lo.signbit().any())
    inf = torch.tensor([float("inf"), -float("inf")])
    hi, lo = fa.split_tf32_plain(inf)
    assert torch.equal(hi, inf) and bool(lo.isnan().all())
    nans = fa._from_bits(torch.tensor([0x7FC00000, 0x7FFFFFFF, 0xFFFFFFFF,
                                       0xFFC00000, 0x7F800001]))
    assert bool(nans.isnan().all())
    _, lo = fa.split_tf32_plain(nans)
    assert bool(lo.isnan().all())
    # the largest finite values round into inf, as round-to-nearest does
    top = fa._from_bits(torch.tensor([0x7F7FF000, 0xFF7FF000]))
    hi, _ = fa.split_tf32_plain(top)
    assert torch.equal(hi, torch.tensor([float("inf"), -float("inf")]))


def test_split_rounds_ties_away_from_zero():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                      -(1.0 + 3 * 2.0 ** -11), 1.0 + 2.0 ** -10 - 2.0 ** -23])
    hi, lo = fa.split_tf32_plain(x)
    assert hi.tolist() == [1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -9),
                           1.0 + 2.0 ** -10]
    assert torch.equal(hi + lo, x)


def _large_term_scores(seed):
    """A 64 x 64 score block at llama's head dim: normal q x 100 (the
    softcap checks' q scaled by 2 caps of 50) against normal k."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((64, 64)) * 100.0).astype(np.float32)
    k = rng.standard_normal((64, 64)).astype(np.float32)
    exact = torch.from_numpy(np.einsum("sd,td->st", np.float64(q),
                                       np.float64(k)))
    return torch.from_numpy(q), torch.from_numpy(k).T.contiguous(), exact


def _distances(split, seed=0):
    q, kt, exact = _large_term_scores(seed)
    f32 = float(torch.linalg.norm((q @ kt).double() - exact))
    got = float(torch.linalg.norm(fa.split_dot_plain(q, kt, split).double()
                                  - exact))
    return got, f32


def test_rounded_split_dot_is_as_close_to_f64_as_an_f32_matmul():
    """Seed 0: the rounded split lies within 1.5x of the f32 matmul's
    distance from the f64 einsum (1.09x here; 1.06-1.11x over seeds
    0-7)."""
    got, f32 = _distances(fa.split_tf32_plain)
    assert got <= 1.5 * f32, (got, f32)


def test_truncating_split_dot_is_outside_that_bound():
    """The same block (seed 0) through the first split: 2.59x the f32
    matmul's distance (2.55-2.63x over seeds 0-7), the bias of two cuts
    toward zero."""
    got, f32 = _distances(_truncating_split)
    assert got > 1.5 * f32, (got, f32)


def test_f32_sources_take_the_shared_split():
    """The forward and the backward pair include the one split and keep
    none of their own; its body is what ``split_tf32_plain`` models."""
    header = (CSRC / "tf32_split.cuh").read_text()
    body = header[header.index("void tf32_split("):]
    assert body.count("+ 0x1000u) & 0xffffe000u") == 2
    assert "min(rest, 0x7fffefff)" in body and "cvt" not in body
    for name in ("flash_attention.cu", "flash_attention_bwd.cu"):
        src = (CSRC / name).read_text()
        assert '#include "tf32_split.cuh"' in src
        assert not re.search(r"void \w*split\w*\(float", src)
        assert "tf32_split(" in src


def test_f32_sources_take_the_shared_products_and_score_sums():
    """The forward and the backward pair take their split products and
    the score products' sums (score_step, score_fold) from one header and
    define none of their own, so the pair forms S as the forward did; the
    odd k-steps go to a second sum above D = 64 only."""
    header = (CSRC / "tf32_mma.cuh").read_text()
    step = header[header.index("void score_step("):
                  header.index("void score_fold(")]
    assert "if constexpr (D > 64)" in step
    assert step.count("mma3_from_zero(odd, a1h") == 1
    assert step.count("mma3_from_zero(even, a1h") == 1
    for name in ("flash_attention.cu", "flash_attention_bwd.cu"):
        src = (CSRC / name).read_text()
        assert '#include "tf32_mma.cuh"' in src
        assert not re.search(r"void \w*mma(_tf32|3)\w*\(", src)
        assert "void score_" not in src
        assert "score_step<D>(" in src and "score_fold<D>(" in src


# -- chip_smoke.check_against_f64: the gate beside the f64 one ----------------

def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _scaled_case(seed, s, h, d):
    """A capped case on normal q x 100 (CPU tensors), its f32 twin and
    the f64 answer."""
    smoke = _chip_smoke()
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32))
               for shape in ((1, s, h, d), (1, s, 2, d), (1, s, 2, d)))
    q = q * 100.0
    twin = fa.gqa_plain(q, k, v, softcap=50.0)
    exact = smoke.f64_attention(q, k, v, 50.0)
    return smoke, q, k, v, twin, exact


def test_f64_gate_holds_the_kernel_to_its_twins_distance_in_rms():
    """A kernel output as far from the f64 answer as the twin passes; one
    whose every output sits at the twin's largest distance (so its max
    abs ratio is 1) fails the root mean square ratio."""
    smoke, q, k, v, twin, exact = _scaled_case(0, 96, 4, 16)
    row = smoke.check_against_f64("twin", twin, twin, q, k, v, 50.0)
    assert row["kernel_over_twin_rms"] == 1.0
    assert row["kernel_over_twin_vs_f64"] == 1.0
    err = twin.double() - exact
    flat = (exact + float(err.abs().max()) * torch.where(err < 0, -1.0, 1.0)
            .double()).float()
    with pytest.raises(SystemExit, match="root mean square"):
        smoke.check_against_f64("flat", flat, twin, q, k, v, 50.0)


@pytest.mark.parametrize("s,h,d", [(96, 4, 16), (1024, 16, 64)])
def test_f64_gate_holds_max_abs_on_every_case(s, h, d):
    """One output moved by 3x the twin's largest error (still inside the
    f64 tolerance) fails the max abs ratio, on a small case as on a large
    one."""
    smoke, q, k, v, twin, exact = _scaled_case(1, s, h, d)
    err = (twin.double() - exact).abs()
    at = int(err.argmin())
    moved = twin.clone().reshape(-1)
    moved[at] = float(exact.reshape(-1)[at] + 3.0 * float(err.max()))
    moved = moved.reshape(twin.shape)
    with pytest.raises(SystemExit, match="in max abs"):
        smoke.check_against_f64("moved", moved, twin, q, k, v, 50.0)
