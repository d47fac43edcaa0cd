"""``tools/k5_variants.py`` (the selective-scan kernel's variants, timed
on a GPU) keeps applying to the committed kernel source: every patch
finds its anchors, and each variant differs from the kernel where it
should.  The variants themselves build and run only on a card."""

import importlib.util
import re
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "k5_variants", ROOT / "tools" / "k5_variants.py")
k5v = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(k5v)
SOURCE = (ROOT / "src" / "repro_torch" / "kernels" / "csrc"
          / "ssm_scan.cu").read_text()

# what each variant's source must hold beyond the committed kernel
MARKERS = {"lpc2": ["constexpr int SS_LPC = 2;",
                    "__shfl_xor_sync(0xffffffffu, yv, off)",
                    "a_log[(long long)d * N + n0 + n]"],
           "lpc4": ["constexpr int SS_LPC = 4;",
                    "constexpr int SS_MIN_BLOCKS = 4;"],
           "tb8": ["constexpr int SS_TB = 8;"],
           "tb16": ["constexpr int SS_TB = 16;"],
           "w4": ["constexpr int SS_WARPS = 4;",
                  "constexpr int SS_MIN_BLOCKS = 4;"],
           "w12": ["constexpr int SS_WARPS = 12;",
                   "constexpr int SS_MIN_BLOCKS = 1;"],
           "w16": ["constexpr int SS_WARPS = 16;",
                   "constexpr int SS_MIN_BLOCKS = 1;"],
           "seg32": ["constexpr int SS_SEG = 32;"],
           "seg128": ["constexpr int SS_SEG = 128;"],
           "seg512": ["constexpr int SS_SEG = 512;"]}


@pytest.mark.parametrize("name", sorted(k5v.VARIANTS))
def test_variant_patches_apply_to_the_committed_kernel(name):
    src = k5v.patched(name, SOURCE)
    if name == "v0":
        assert src == SOURCE
        return
    assert src != SOURCE
    for marker in MARKERS[name]:
        assert marker in src, marker
    # the C strings of the inline PTX keep their escaped newlines
    assert "\\n\"" in src and src.count("\n\"") == 0


@pytest.mark.parametrize("name", ["lpc2", "lpc4"])
def test_lanes_a_channel_hold_a_share_of_the_states_everywhere(name):
    """With lanes sharing a channel, no loop or array of the scan kernel
    still spans all N states of a lane, and the scratch's carries shrink
    with the share."""
    src = k5v.patched(name, SOURCE)
    kernel = src[src.index("ssm_scan_kernel(const T*"):
                 src.index("// S = 1: one step from h0")]
    assert not re.search(r"\[N\];|n < N;|\* N \* 32|\[N \* 32", kernel)
    assert "items * (N / SS_LPC) * 32" in src


def test_switches_name_only_known_variants():
    assert set(MARKERS) | {"v0"} == set(k5v.VARIANTS)
    assert all(callable(p) for ps in k5v.VARIANTS.values() for p in ps)


def test_cases_reach_the_kernels_edges():
    """Both dtypes, with and without h0, S = 1 and S past one chunk,
    every state size."""
    cases = k5v.CASES
    assert {c[5] for c in cases} == {"float32", "bfloat16"}
    assert {c[4] for c in cases} == {4, 8, 16}
    assert any(c[2] == 1 for c in cases) and max(c[2] for c in cases) >= 4096
    assert any(c[6] for c in cases) and not all(c[6] for c in cases)


def test_the_tool_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert k5v.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
