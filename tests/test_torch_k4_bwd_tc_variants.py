"""``tools/k4_bwd_tc_variants.py`` (K4's bf16 backward kernels' variants,
timed on a GPU) keeps applying to the committed kernel source: every
patch finds its anchors once, and each variant differs from the kernels
where it should.  The variants themselves build and run only on a
card."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_spec = importlib.util.spec_from_file_location(
    "k4_bwd_tc_variants", ROOT / "tools" / "k4_bwd_tc_variants.py")
kbt = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kbt)
SOURCE = kbt.SOURCE.read_text()

# what each variant's source must hold that the committed kernels do not
MARKERS = {"masks_always": ["if (false && t0 + BK <= T",
                            "if (false && r0 + BM <= S"],
           "one_part": [],
           "both_products": ["uint32_t hi2[4][4], lo2[4][4];"],
           "overlap": ["issue_sdp(j + 1);", "issue_sdp(i + 1);"],
           "kv64": ["kv_keys() { return 64; }",
                    "constexpr bool SPLIT = true;"]}


@pytest.mark.parametrize("name", sorted(kbt.VARIANTS))
def test_variant_patches_apply_to_the_committed_kernels(name):
    src = kbt.patched(name)
    if name == "v0":
        assert src == SOURCE
        return
    assert src != SOURCE
    for marker in MARKERS[name]:
        assert marker in src and marker not in SOURCE, marker
    if name == "one_part":
        assert kbt.LO_PRODUCT in SOURCE and kbt.LO_PRODUCT not in src
    # the C strings of the inline PTX keep their escaped newlines
    assert "\\n\"" in src and src.count("\n\"") == 0


def test_every_variant_but_v0_has_its_markers_and_one_part_is_unchecked():
    assert set(MARKERS) | {"v0"} == set(kbt.VARIANTS)
    assert [n for n, (_, checked) in kbt.VARIANTS.items()
            if not checked] == ["one_part"]
