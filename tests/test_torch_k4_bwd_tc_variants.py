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
                    "constexpr bool SPLIT = true;"],
           "cap_interior": ["if (t0 + BK <= T && r0 + 64 <= S",
                            "s[i] = ex2(fmaf(cap_m2, r, rb_ ? cl_b : cl_a))"],
           "cap_wait_both": ["// both products waited on: P^T in S^T's place",
                        "* (4.0f * fmaf(-r, r, r));"],
           "cap_late_dv": ["dp[e] = (dp[e] - dl_c[col]) * s[e] * dtanh[e];"],
           "cap_split_wait": ["// both products waited on: P^T in S^T's place"],
           "cap_kv_masked": ["if (!CAP && r0 + BM <= S && kw0 + 64 <= T"],
           "tanhf": ["const float th = tanhf(s[i] * k2);",
                     "const float th = tanhf(s[e] * k2);", kbt.SC_CAP]}


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


def test_capped_anchors_are_found_once_and_tanhf_leaves_no_helper_call():
    """The anchors of ``tanhf`` and ``cap_interior`` each once in the
    committed kernels (the launches' k2 twice: dq and dkdv); the
    ``tanhf`` variant calls no softcap_r, ``cap_interior`` one more."""
    for anchor in (kbt.DQ_INTERIOR, kbt.KV_INTERIOR, kbt.DQ_INTERIOR_LOOP,
                   kbt.DQ_CAP, kbt.KV_CAP, kbt.KV_DTANH, kbt.KV_CAP_PRODUCTS,
                   kbt.KV_PLAIN_PRODUCTS, kbt.KV_DK_MUL, kbt.KV_EARLY_DV,
                   kbt.KV_INTERIOR_CAP):
        assert SOURCE.count(anchor) == 1, anchor[:60]
    assert SOURCE.count(kbt.CAP_K2) == 2 and "tanhf" not in SOURCE
    # dq's masked path; dkdv's interior and masked paths
    assert SOURCE.count("softcap_r(") == 3
    src = kbt.patched("tanhf")
    assert kbt.CAP_K2 not in src and src.count(kbt.SC_CAP) == 2
    assert "softcap_r(" not in src
    assert kbt.patched("cap_interior").count("softcap_r(") == 4
    assert kbt.patched("cap_kv_masked").count("softcap_r(") == 2


def test_cap_wait_both_restores_the_wait_for_both_products():
    """``cap_wait_both`` (also under ``tanhf``): dkdv's CAP item takes the
    masked path, waits for both products, forms dS^T in the element loop
    and shares the second products of the kernels without a cap; no
    dtanh array, no second set of parts."""
    for name in ("cap_wait_both", "tanhf"):
        src = kbt.patched(name)
        assert src.count(kbt.KV_WAIT_BOTH) == 1
        for gone in ("dtanh", "split_frags(dp, ds_hi", kbt.KV_CAP_PRODUCTS,
                     kbt.KV_PLAIN_PRODUCTS, kbt.KV_DK_MUL,
                     kbt.KV_INTERIOR_CAP, kbt.KV_TAIL_SELECT):
            assert gone not in src, (name, gone)
    src = kbt.patched("cap_wait_both")
    assert src.count(kbt.KV_CAP_TOGETHER) == 1 and kbt.KV_CAP not in src
    assert "if (!CAP && r0 + BM <= S && kw0 + 64 <= T" in src
    # dq and every kernel without a cap untouched; dk scaled as without
    # a cap (the earlier item's dS^T carries its 4)
    assert src.count(kbt.DQ_CAP) == 1
    assert src.count("const float dk_mul = scale;") == 1
    assert src.count("            if constexpr (SPLIT) {\n") == 1
