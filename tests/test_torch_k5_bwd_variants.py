"""``tools/k5_bwd_variants.py`` (ablations of K5's f32 backward kernel,
timed on a GPU) keeps applying to the committed kernel source: every
patch finds its anchor once, and each variant differs from the kernel
where it should.  The variants themselves build and run only on a
card."""

import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "k5_bwd_variants", ROOT / "tools" / "k5_bwd_variants.py")
kbv = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kbv)
SOURCE = kbv.SOURCE.read_text()

# what each variant's source must hold that the committed kernel does
# not
MARKERS = {"no_reduce_scatter": ["const float part = vals[0] + vals[V - 1];"],
           "no_walk_back": ["if (i >= cnt || S > 0) {"],
           "pass1_only": ["const int nb = 0;"]}


@pytest.mark.parametrize("name", sorted(kbv.VARIANTS))
def test_variant_patches_apply_to_the_committed_kernel(name):
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


def test_the_tool_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kbv.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
