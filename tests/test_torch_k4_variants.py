"""``tools/k4_variants.py`` (the attention kernel's variants, timed on a
GPU) keeps applying to the committed kernel source: every patch finds
its anchors, and each variant differs from the kernel where it should.
The variants themselves build and run only on a card."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "k4_variants", ROOT / "tools" / "k4_variants.py")
k4v = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(k4v)
SOURCE = (ROOT / "src" / "repro_torch" / "kernels" / "csrc"
          / "flash_attention.cu").read_text()

# what each variant's source must hold beyond the committed kernel
MARKERS = {"p_single": ["wgmma_pv<D>(o, pf[kk], desc_v);\n            }"],
           "serial": ["wgmma_wait<0>();\n            fence_regs(o);"],
           "serial_tree4": ["FA_NA"],
           "overlap": ["issue_pv(sp);"],
           "pingpong_branching": ["n_turns"],
           "all_lanes": ["mbar_init(empty_k(st), 256);"],
           "serial_bq192": ["constexpr int BQ = 64 * NWG;"],
           "overlap_bq192": ["constexpr int BQ = 64 * NWG;"],
           "stages4": ["FA_STAGES"],
           "l2_256": ["CU_TENSOR_MAP_L2_PROMOTION_L2_256B"],
           "no_softmax": ["#ifndef ABL_NOSOFTMAX"],
           "no_products": ["#ifndef ABL_NOQK", "#ifndef ABL_NOPV"],
           "loads_only": ["#ifndef ABL_NOSOFTMAX"],
           "loads_only_bq192": ["FA_NWG", "#ifndef ABL_NOQK"]}


def _patched(name):
    src = SOURCE
    for patch in k4v.VARIANTS[name][0]:
        src = patch(src)
    return src


@pytest.mark.parametrize("name", sorted(k4v.VARIANTS))
def test_variant_patches_apply_to_the_committed_kernel(name):
    src = _patched(name)
    if name == "v0":
        assert src == SOURCE
        return
    assert src != SOURCE
    for marker in MARKERS[name]:
        assert marker in src, marker
    # the C strings of the inline PTX keep their escaped newlines
    assert "\\n\"" in src and src.count("\n\"") == 0


def test_switches_name_only_known_variants():
    assert set(MARKERS) | {"v0"} == set(k4v.VARIANTS)
    for patches, defines, _ in k4v.VARIANTS.values():
        assert all(d.startswith("-D") for d in defines)
