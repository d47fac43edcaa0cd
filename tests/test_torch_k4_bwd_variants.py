"""``tools/k4_bwd_variants.py`` (K4's f32 backward kernels' variants,
timed on a GPU) keeps applying to the committed kernel source: every
patch finds its anchor once, and each variant differs from the kernels
where it should.  The variants themselves build and run only on a
card."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


kbv = _tool("k4_bwd_variants")
SOURCE = kbv.SOURCE.read_text()

# what each variant's source must hold that the committed kernels do not
TRUNC = "hi = __float_as_uint(x) & 0xffffe000u;"
CHAINED = "    mma3(even, a1h, a1l, bh[2], bh[3], bl[2], bl[3]);"
ONE_SUM = "bl[1]);\n    mma3_from_zero(even, a1h, a1l, bh[2], bh[3]"
MARKERS = {"rna": ["cvt.rna.tf32.f32 %0, %1;\\n"],
           "rnahi": ["+ 0x1000u) & 0xffffe000u",
                     "lo = __float_as_uint(x - __uint_as_float(hi));"],
           "one_sum": [ONE_SUM, "#define FB_WIDE_UNROLL 4"],
           "chained": [CHAINED, "#define FB_WIDE_UNROLL 4"],
           "trunc_chained": [TRUNC, CHAINED, "#define FB_WIDE_UNROLL 4"],
           "wu1": ["#define FB_WIDE_UNROLL 1"],
           "kv32": ["D == 128 ? (DKDV ? 32 : 64) : 32;"],
           "d80kv48": ["D == 80 ? (DKDV ? 48 : 64) :"],
           "d80m32": ["D == 80 ? 32 :"]}


@pytest.mark.parametrize("name", sorted(kbv.VARIANTS))
def test_variant_patches_apply_to_the_committed_kernels(name):
    src = kbv.patched(name)
    if name == "v0":
        assert src == SOURCE
        return
    assert src != SOURCE
    for marker in MARKERS[name]:
        assert marker in src and marker not in SOURCE, marker
    # the C strings of the inline PTX keep their escaped newlines
    assert "\\n\"" in src and src.count("\n\"") == 0


def test_every_variant_but_v0_has_its_markers():
    assert set(MARKERS) | {"v0"} == set(kbv.VARIANTS)


# the forward's own markers where they are not the pair's
FWD_MARKERS = {name: [m.replace("FB_WIDE", "FA_WIDE") for m in marks]
               for name, marks in MARKERS.items()}


@pytest.mark.parametrize("name", sorted(kbv.FWD_VARIANTS))
def test_scaled_mode_patches_the_forward_with_the_pairs_split(name):
    """Under --scaled a variant of the split or of the score sums patches
    its forward as its pair: the marker in both; a split of its own
    replaces the shared split's include in both, sums of their own the
    shared products' include."""
    fwd, pair = kbv.patched_forward(name), kbv.patched(name)
    fwd_src = kbv.FWD_SOURCE.read_text()
    for marker in MARKERS[name]:
        assert marker in pair
    for marker in FWD_MARKERS[name]:
        assert marker in fwd and marker not in fwd_src, marker
    own_split = name in ("rna", "rnahi", "trunc_chained")
    own_sums = name in ("one_sum", "chained", "trunc_chained")
    for text in (fwd, pair):
        assert ('#include "tf32_split.cuh"' not in text) == own_split
        assert ('#include "tf32_mma.cuh"' not in text) == own_sums


def test_other_variants_keep_the_committed_forward():
    """The tiling variants take the committed forward."""
    fwd_src = kbv.FWD_SOURCE.read_text()
    for name in ("wu1", "kv32", "d80kv48", "d80m32"):
        assert kbv.patched_forward(name) == fwd_src


def test_smoke_cases_replay_the_gated_phases_draws():
    """The scaled forward's small cases are the f32 cases on q x 100 of
    ``softcap_checks`` and ``softcap_bwd_checks``: every head dim under
    every mask, in each phase."""
    import chip_smoke as smoke
    src = (ROOT / "tools" / "k4_bwd_variants.py").read_text()
    assert '("softcap_checks", 13, "qkv")' in src
    assert '("softcap_bwd_checks", 41, "qdkv")' in src
    smoke_src = (ROOT / "chip_smoke.py").read_text()
    assert ('gen = torch.Generator(device="cuda").manual_seed(13)\n'
            '    rows = []\n    zero_counts()\n    for d in HEAD_DIMS:\n'
            '        for dtype in (torch.float32, torch.bfloat16):'
            in smoke_src)
    assert ('gen = torch.Generator(device="cuda").manual_seed(41)\n'
            '    rows = []\n    zero_counts()\n    for d in HEAD_DIMS:\n'
            '        for dtype in (torch.float32, torch.bfloat16):'
            in smoke_src)
    assert len(smoke.SOFTCAP_MASKS) == 3
