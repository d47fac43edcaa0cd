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
           "multicast": ["static constexpr bool CLUSTER = D > 64;",
                         "tma_load_4d_mc(dst, map, full,",
                         "cudaLaunchAttributeClusterDimension",
                         "if constexpr (L::CLUSTER) cluster_sync();\n}"],
           "multicast_loads_only": ["static constexpr bool CLUSTER = D > 64;",
                                    "#ifndef ABL_NOSOFTMAX"],
           "remote_arrivals": ["if (lane == 0) arrive2(empty_k(st));",
                               "mbar_init(empty_k(st), 8 * (mcast ? 2 : 1));"],
           "remote_arrivals_no_mc": ["if (lane == 0) arrive2(empty_k(st));",
                                     "if (0)\n"],
           "no_multicast": ["static constexpr bool CLUSTER = D > 64;",
                            "const int mcast = 0 && L::CLUSTER"],
           "depth2": ["DEPTH = WIDE ? 2 : STAGES;"],
           "tanhf": ["cap_log2 * tanhf(s[i] * k2)",
                     "CAP ? (float)((double)scale / softcap) : 0.0f,",
                     "        if (w == 1)\n"],
           "cap_turns": ["        if (w == 1)\n", "        if (w == 0)\n"],
           "fma_exp": ["float ex2_fma(float x)", "? ex2_fma(s[i] - m_new[r])"],
           "fma_exp_quarter": ["? ex2_fma(s[i] - m_new[r])"],
           "rescale_under_qk": ["issue_qk(st);\n                wgmma_commit();\n"
                                "                rescale<D>(o, corr);"],
           "keys64": ["KEYS = D <= 128 ? BK : 64;"],
           "f32_keys32": ["{ return D <= 128 ? FA_BK : 32; }"],
           "f32_unroll4": ["#define FA_WIDE_UNROLL 4"],
           "f32_rna": ["cvt.rna.tf32.f32 %0, %1;\\n"],
           "f32_rnahi": ["+ 0x1000u) & 0xffffe000u"],
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


def test_multicast_cluster_lives_only_in_its_patch():
    """The kernel launches no cluster: the 2-CTA multicast path (measured
    slower on an H100) is the ``multicast`` patch's alone, and every
    variant built on it carries the whole path."""
    for word in ("CLUSTER", "multicast::cluster", "cudaLaunchKernelEx",
                 "barrier.cluster", "mapa."):
        assert word not in SOURCE, word
    for name in ("multicast", "multicast_loads_only", "no_multicast",
                 "remote_arrivals", "remote_arrivals_no_mc"):
        src = _patched(name)
        assert src.count("cluster_sync();") == 3, name
        assert "Layout<D>::HALF};" in src and "Layout<D>::KEYS};" not in src


def test_capped_anchors_are_found_as_the_tanhf_variant_needs():
    """The capped score twice in softmax_tile (masked and interior
    tiles), the launch's k2 once; ``tanhf`` leaves neither, and the
    capped variants are built with the softcap instantiations."""
    assert SOURCE.count(k4v.CAP_TILE) == 2 and SOURCE.count(k4v.CAP_K2) == 1
    for anchor in (k4v.TURN_BEGIN, k4v.TURN_END, k4v.TURN_FIRST,
                   k4v.TURN_LAST, k4v.SOFTMAX_EXP):
        assert SOURCE.count(anchor) == 1, anchor[:60]
    src = _patched("tanhf")
    assert k4v.CAP_TILE not in src and k4v.CAP_K2 not in src
    assert src.count("tanhf(s[i] * k2)") == 2
    # the turns without a condition, as before the cap skipped them
    assert "!CAP" not in _patched("cap_turns").split("auto turn_begin")[1] \
        .split("if (n_rows > 0) {")[0]
    assert set(k4v.CAPPED) <= set(k4v.WIDE) and "tanhf" in k4v.CAPPED
    assert set(k4v.CAP_SHAPES) == {"llama-4096-causal-cap50",
                                   "llama-2048-causal-cap50-lse"}
