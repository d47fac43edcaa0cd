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
MARKERS = {"rna": ["cvt.rna.tf32.f32 %0, %1;\\n"],
           "rnahi": ["+ 0x1000u) & 0xffffe000u"],
           "wu1": ["#define FB_WIDE_UNROLL 1"],
           "wu2": ["#define FB_WIDE_UNROLL 2"],
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
