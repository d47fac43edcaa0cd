"""``tools/fedagg_variants.py`` (K1-K3's stream variants and the crossover
grid of the single launch against the tiled route, timed on a GPU) keeps
applying to the committed kernel source: every patch finds its anchors
as often as it says, and each variant differs from the kernels where it
should.  The variants themselves build and run only on a card."""

import importlib.util
from pathlib import Path

import pytest

from repro_torch.kernels import fedagg as fa

ROOT = Path(__file__).resolve().parents[1]

_spec = importlib.util.spec_from_file_location(
    "fedagg_variants", ROOT / "tools" / "fedagg_variants.py")
fv = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fv)
SOURCE = fv.SOURCE.read_text()

# what each variant's source must hold that the committed kernels do not
MARKERS = {"ring32": ["static constexpr int ROWS = 32;"],
           "ring64": ["static constexpr int ROWS = 64;"],
           "ring128": ["sizeof(V) == 16 ? 32 : 128;"],
           "wide": ["long long t = FEDAGG_THREADS;"],
           "single_ring": ["__device__ __forceinline__ V ring_live_rows(",
                           "static int ring_grid(K kernel, long long p,"]}


@pytest.mark.parametrize("name", sorted(fv.VARIANTS))
def test_variant_patches_apply_to_the_committed_kernels(name):
    src = fv.patched(name)
    if name == "v0":
        assert src == SOURCE
        return
    assert src != SOURCE
    for marker in MARKERS[name]:
        assert marker in src and marker not in SOURCE, marker


def test_every_variant_but_v0_has_its_markers():
    assert set(MARKERS) | {"v0"} == set(fv.VARIANTS)


def test_single_ring_folds_every_single_launch_through_the_ring():
    """``single_ring``: the three single-launch kernels (one a mode)
    call the ring in place of the batch loop, and each launch sizes its
    grid by ``ring_grid`` for its own kernel and shared bytes; the tiled
    route's kernels are untouched."""
    src = fv.patched("single_ring")
    assert SOURCE.count(fv.SUM_CALL) == 3
    assert fv.SUM_CALL not in src and src.count(fv.RING_CALL) == 3
    for kernel, rows in (("fedagg_kernel", "n"), ("fedagg_fold_kernel", "k"),
                         ("fedagg_partial_kernel", "n")):
        assert (f"ring_grid<V>({kernel}<V>, p, smem, &blocks, &threads);"
                in src)
        assert f"{kernel}<V><<<blocks, threads, smem, stream>>>(" in src
        assert f"const size_t smem = (size_t){rows} * " in src
    assert "grid_blocks<V>(p, &blocks)" not in src
    ws = SOURCE[SOURCE.index("#define FEDAGG_WS_MAX_ROWS"):]
    assert src.endswith(ws)


def test_grid_spans_both_sides_of_the_route_crossover():
    """The grid's rows hold the main path's cohorts (8, 32), the
    crossover of ``fedagg.tiled_route`` on each side and the single
    launch's 4,096."""
    assert fv.GRID_ROWS[0] <= 8 and 32 in fv.GRID_ROWS
    assert {fa.ROUTE_ROWS // 2, fa.ROUTE_ROWS, fv.SINGLE} <= set(fv.GRID_ROWS)
    assert fv.MODES == ("fedagg", "fedagg_fold", "fedagg_partial")
