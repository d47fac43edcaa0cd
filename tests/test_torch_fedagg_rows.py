"""K1–K3 past 4,096 rows (``kernels/fedagg.py``): the wrappers route
more rows than a single launch holds to the tiled twins of their entries
(``csrc/fedagg.cu: *_ws``) with a workspace sized for the launch, raise
only past the tiled route's own limit, and whole FL runs of more than
4,096 clients equal the reference's.

The tiled kernels run only on a card (``chip_smoke.py`` holds them
against their plain twins, bit for bit against the single launch); here
a fake library stands in for the built one and records each call.
Histories are compared as ``tests/test_torch_async.py`` compares them:
every field exactly, accuracy within 1e-6.
"""

import ctypes
import types

import numpy as np
import pytest
import torch

from repro.config.base import FLConfig
from repro.core import baselines as ref_baselines
from repro.fl.network import WirelessNetwork
from repro.fl.testing import SyntheticCohortTrainer as RefSynthetic
from repro_torch.config.base import FLConfig as PtFLConfig
from repro_torch.core import baselines as pt_baselines
from repro_torch.fl.network import WirelessNetwork as PtNetwork
from repro_torch.fl.testing import SyntheticCohortTrainer
from repro_torch.kernels import fedagg as fa

torch.set_num_threads(1)

SINGLE = 4096           # FEDAGG_MAX_ROWS
LIMIT = 1 << 30         # FEDAGG_WS_MAX_ROWS
ROUTE = 128             # fedagg.ROUTE_ROWS: tall calls take the tiled route


class FakeLib:
    """The built library's row limits and entries; each entry records
    its arguments and returns 0 (cudaSuccess)."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def fedagg_max_rows():
        return SINGLE

    @staticmethod
    def fedagg_ws_max_rows():
        return LIMIT

    @staticmethod
    def fedagg_ws_floats(n):
        return 2 * n + 2

    def __getattr__(self, name):
        if not name.startswith("fedagg_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("what,rows,held", [
    ("fedagg", SINGLE, None), ("fedagg", SINGLE + 1, None),
    ("fedagg", 8192, None), ("fedagg_partial", SINGLE + 1, None),
    ("fedagg_fold", SINGLE - 1, SINGLE), ("fedagg_fold", SINGLE, SINGLE + 1),
    ("fedagg_fold", 8192, 8193)])
def test_workspace_is_sized_for_the_tiled_launch(what, rows, held):
    """At 4,096 coefficients and past them (past the route's 128) the
    tiled route takes the call, its workspace of
    ``fedagg_ws_floats(rows)`` floats: the packed coefficients, their
    row indices, the live count and the global coefficient; under 128
    coefficients no workspace.  ``fedagg_fold`` holds its rows + 1."""
    ws = fa._workspace(FakeLib(), what, rows, "cpu", held=held)
    assert ws.dtype == torch.float32 and ws.shape == (2 * rows + 2,)
    held = ROUTE - 1
    assert fa._workspace(FakeLib(), what, held - (what == "fedagg_fold"),
                         "cpu", held=held) is None


@pytest.mark.parametrize("what", ["fedagg", "fedagg_fold",
                                  "fedagg_partial"])
def test_past_the_tiled_limit_raises_naming_it(what):
    lib = FakeLib()
    assert fa._workspace(lib, what, LIMIT, "meta") is not None
    with pytest.raises(ValueError, match=f"{LIMIT + 1} rows exceed the "
                                         f"{LIMIT}"):
        fa._workspace(lib, what, LIMIT + 1, "meta")


@pytest.mark.parametrize("entry,args", [
    ("fedagg_f32", (11, 12, 13, 14, 5000, 64, 4)),
    ("fedagg_fold_f32", (11, 12, 13, 14, 5000, 64, 4)),
    ("fedagg_partial_f32", (11, 12, 14, 5000, 64, 4))])
def test_launch_puts_the_workspace_after_the_output(entry, args):
    """The tiled twin ``<entry>_ws`` takes the entry's arguments with the
    workspace's address after the output; one call counts one tiled
    launch.  Without a workspace the entry itself is called."""
    lib, stream = FakeLib(), 99
    assert fa._launch(lib, entry, None, args, stream) == 0
    before = fa.tiled_launches
    ws = torch.empty(2 * 5000 + 2)
    assert fa._launch(lib, entry, ws, args, stream) == 0
    assert fa.tiled_launches == before + 1
    out = fa._ENTRIES[entry].index(ctypes.c_int)
    assert lib.calls == [
        (entry, (*args, stream)),
        (f"{entry}_ws", (*args[:out], ws.data_ptr(), *args[out:], stream))]


def test_lib_types_each_tiled_entry_with_the_workspace_after_the_output(
        monkeypatch):
    """``_lib`` types each ``*_ws`` entry as its single-launch entry with
    one pointer more, after the output, and the size queries."""
    from repro_torch.kernels import _build

    class Fn:
        argtypes = restype = None

    names = [n for e in fa._ENTRIES for n in (e, f"{e}_ws")] + [
        "fedagg_max_rows", "fedagg_ws_max_rows", "fedagg_ws_floats"]
    lib = types.SimpleNamespace(**{n: Fn() for n in names})
    monkeypatch.setattr(_build, "load", lambda name: lib)
    assert fa._lib() is lib
    for entry, want in fa._ENTRIES.items():
        cut = want.index(ctypes.c_int)
        assert want[cut - 1] is ctypes.c_void_p            # the output
        assert getattr(lib, entry).argtypes == want
        assert getattr(lib, f"{entry}_ws").argtypes == [
            *want[:cut], ctypes.c_void_p, *want[cut:]]
    assert lib.fedagg_ws_floats.argtypes == [ctypes.c_int]
    assert lib.fedagg_ws_floats.restype is ctypes.c_longlong


@pytest.mark.parametrize("what", ["fedagg", "fedagg_partial"])
def test_tall_calls_take_the_tiled_route_from_the_crossover(what):
    """Under 128 rows the single launch takes the call; from 128 on the
    tiled route's workspace, up to 4,096 rows and past them."""
    lib = FakeLib()
    assert fa._workspace(lib, what, ROUTE - 1, "cpu") is None
    for rows in (ROUTE, SINGLE, SINGLE + 1):
        ws = fa._workspace(lib, what, rows, "cpu")
        assert ws is not None and ws.shape == (2 * rows + 2,)


def test_fold_routes_by_its_held_rows_plus_one():
    """``fedagg_fold`` holds its k rows and the global row: k = 127 rows
    hold 128 coefficients and take the tiled route (a workspace of its
    k rows), k = 126 the single launch."""
    lib = FakeLib()
    assert fa._workspace(lib, "fedagg_fold", ROUTE - 2, "cpu",
                         held=ROUTE - 1) is None
    ws = fa._workspace(lib, "fedagg_fold", ROUTE - 1, "cpu", held=ROUTE)
    assert ws is not None and ws.shape == (2 * (ROUTE - 1) + 2,)


@pytest.mark.parametrize("held,want", [
    (ROUTE - 1, False), (ROUTE, True), (SINGLE, True), (SINGLE + 1, True)])
def test_tiled_route_rule(held, want):
    assert fa.ROUTE_ROWS == ROUTE
    assert fa.tiled_route(held) is want


def test_main_path_calls_keep_the_single_launch():
    """The FL paths' calls (K1 at N = 5 and 32, K2 at K = 8 and 32, K3 at
    R = 2 and 8) stay on the single launch."""
    for held in (5, 32, 9, 33, 2, 8):
        assert not fa.tiled_route(held)


@pytest.mark.parametrize("n", [SINGLE + 1, 5000])
def test_plain_twins_past_4096_rows_ignore_appended_zero_rows(n):
    """The plain twins have no cap: at more than 4,096 rows, rows of
    coefficient 0 appended up to 8,192 change no bit of K2's and K3's
    (the row-ordered sums the kernels take), and K1's agrees within
    1e-6 (``torch.sum`` over rows)."""
    rng = np.random.default_rng(n)
    p = 37
    u = torch.from_numpy(rng.standard_normal((n, p)).astype(np.float32))
    c = rng.uniform(0.0, 1.0, n).astype(np.float32)
    c[rng.random(n) < 0.2] = 0.0
    pad = 8192 - n
    up = torch.cat([u, torch.full((pad, p), float("nan"))])
    cp = np.concatenate([c, np.zeros(pad, np.float32)])
    g = torch.from_numpy(rng.standard_normal(p).astype(np.float32))
    assert torch.equal(fa.fedagg_partial_plain(u, c),
                       fa.fedagg_partial_plain(up, cp))
    cf = np.concatenate([[0.5], c]).astype(np.float32)
    cfp = np.concatenate([[0.5], cp]).astype(np.float32)
    assert torch.equal(fa.fedagg_fold_plain(u, g, cf),
                       fa.fedagg_fold_plain(up, g, cfp))
    w = torch.from_numpy(c)
    np.testing.assert_allclose(
        fa.fedagg_plain(u, w).numpy(),
        fa.fedagg_plain(up, torch.from_numpy(cp)).numpy(), rtol=0,
        atol=1e-6)


def _smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _resnet8_width():
    """``chip_smoke.resnet8_p``: the floats of the resnet8-cifar10 tree
    as the port builds it."""
    return _smoke().resnet8_p()


@pytest.mark.parametrize("mode,entry,y", [
    ("fedagg", "fedagg_f32", True), ("fedagg", "fedagg_f32", False),
    ("fedagg_fold", "fedagg_fold_f32", True),
    ("fedagg_partial", "fedagg_partial_f32", False)])
def test_smoke_entry_lays_out_each_entrys_arguments(mode, entry, y):
    """``chip_smoke.fedagg_entry`` (the single launch of
    ``fedagg_rows_checks`` and of ``tools/fedagg_variants.py``) names the
    mode's entry and gives one argument a type of ``fedagg._ENTRIES``
    but the stream: the rows, the coefficient pointers, the output just
    before the counts (where ``_launch`` puts the workspace after it),
    the rows, the width and the vector width."""
    n, p = 6, 10
    u, out = torch.zeros(n, p), torch.zeros(p)
    x = torch.zeros(p if mode == "fedagg_fold" else n)
    yt = torch.zeros(n + 1 if mode == "fedagg_fold" else n) if y else None
    got, args = _smoke().fedagg_entry(mode, u, x, yt, out)
    assert got == entry
    cut = fa._ENTRIES[entry].index(ctypes.c_int)
    assert len(args) == len(fa._ENTRIES[entry]) - 1       # no stream
    assert args[0] == u.data_ptr() and args[1] == x.data_ptr()
    assert args[cut - 1] == out.data_ptr()
    assert args[cut:] == (n, p, 2)
    if mode != "fedagg_partial":
        assert args[2] == (None if yt is None else yt.data_ptr())


def test_plain_twins_at_8192_rows_of_the_resnet8_width_ignore_zero_rows():
    """8,192 rows of resnet8-cifar10's width (an odd count of float2s:
    the kernels' vec = 2 path), a fifth of them masked, and the same
    rows with 100 rows of coefficient 0 appended: K2's and K3's twins
    (the row-ordered sums the tiled kernels take) equal bit for bit.
    The rows are overlapping windows of one seeded vector (row i starts
    at element i), so the 8,292 rows cost 340 KB, not 2.6 GB."""
    p = _resnet8_width()
    assert p % 2 == 0 and (p // 2) % 2 == 1
    n, pad = 8192, 100
    rng = np.random.default_rng(8192)
    base = torch.from_numpy(rng.standard_normal(p + n + pad)
                            .astype(np.float32))
    up = torch.as_strided(base, (n + pad, p), (1, 1))
    u = up[:n]
    c = rng.uniform(0.0, 1.0, n).astype(np.float32)
    c[rng.random(n) < 0.2] = 0.0
    cp = np.concatenate([c, np.zeros(pad, np.float32)])
    assert torch.equal(fa.fedagg_partial_plain(u, c),
                       fa.fedagg_partial_plain(up, cp))
    g = torch.from_numpy(rng.standard_normal(p).astype(np.float32))
    cf = np.concatenate([[0.25], c]).astype(np.float32)
    cfp = np.concatenate([[0.25], cp]).astype(np.float32)
    assert torch.equal(fa.fedagg_fold_plain(u, g, cf),
                       fa.fedagg_fold_plain(up, g, cfp))


def _net(cls, fl):
    return cls(fl.n_clients, fl.tier_delay_means, fl.delay_std, fl.mu,
               fl.failure_delay, fl.seed)


def _equal_but_accuracy(got, want):
    g, w = got.to_json(), want.to_json()
    acc_g, acc_w = g.pop("accuracy"), w.pop("accuracy")
    assert g == w
    assert len(acc_g) == len(acc_w) > 0
    np.testing.assert_allclose(acc_g, acc_w, rtol=0, atol=1e-6)


# more than 4,096 clients a round: FedAvg's cohort (K1's rows) and
# FedBuff's window (K2's rows; the store pads it to 8,192)
BIG = 4100
STORE_KEYS = {"store", "store_path", "store_reason", "residency",
              "hot_rows", "store_bytes_hot", "store_bytes_cold",
              "store_bytes_ef"}


@pytest.mark.parametrize("method,fl_kw,kw", [
    ("fedavg", dict(n_clients=BIG, tau=BIG, rounds=2, seed=3), {}),
    ("fedbuff", dict(n_clients=BIG, tau=BIG, rounds=1, seed=2),
     dict(window=BIG, eval_every=1))])
def test_histories_past_4096_clients_equal_the_reference(method, fl_kw, kw):
    """A SyntheticCohortTrainer run whose rounds aggregate more than
    4,096 rows equals the reference's (its Pallas fedagg has no cap),
    with the kernel route asked for; FedBuff's store path equals its
    dict path bit for bit."""
    ref_fl, pt_fl = FLConfig(**fl_kw), PtFLConfig(**fl_kw)
    stores = (True, False) if method == "fedbuff" else (None,)
    runs = {}
    for use_store in stores:
        extra = {} if use_store is None else dict(use_store=use_store)
        want = ref_baselines.run_method(
            method, RefSynthetic(), _net(WirelessNetwork, ref_fl), ref_fl,
            use_kernel_agg=True, **kw, **extra)
        got = pt_baselines.run_method(
            method, SyntheticCohortTrainer(device="cpu"),
            _net(PtNetwork, pt_fl), pt_fl, use_kernel_agg=True, **kw,
            **extra)
        _equal_but_accuracy(got, want)
        runs[use_store] = got
    if method == "fedbuff":
        assert runs[True].meta["store_path"] == "store"

        def strip(h):
            out = h.to_json()
            out["meta"] = {k: v for k, v in out["meta"].items()
                           if k not in STORE_KEYS}
            return out
        assert strip(runs[True]) == strip(runs[False])
        assert runs[True].meta["mean_cohort"] > 4096
