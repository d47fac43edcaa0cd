"""The port's int8 client rows (``quant_bits=8``) with error feedback.

``tests/test_state.py``'s quantized-store cases restated for the port
(its tiered-residency case is in ``tests/test_torch_residency.py``), held against
the numpy oracles (``kernels/ref.py``) bit for bit: the row quantizer,
the store's int8 rows and meta, its dequantized rows and its
error-feedback residuals ``x - dq(q(x))``.  The residual is held to the
oracle, not to the reference's jitted store, whose residual is
FMA-contracted under jax 0.9.0.  On top: the quantizer against the
reference's ``repro.kernels.ops.quantize_rows`` exactly, the oracle
copies pinned to the originals, and whole q8 histories against the
reference's.
"""

from __future__ import annotations

import inspect

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro_torch import bridge
from repro_torch.config.base import FLConfig
from repro_torch.core.baselines import run_fedasync
from repro_torch.core.state import ClientStateStore, wire_bytes
from repro_torch.fl.network import WirelessNetwork
from repro_torch.fl.testing import SyntheticCohortTrainer
from repro_torch.kernels.ops import (QUANT_QMAX, QUANT_STEPS,
                                     dequantize_rows, dequantize_segment,
                                     quantize_rows)
from repro_torch.kernels.ref import dequantize_rows_ref, quantize_rows_ref
from repro_torch.launch import fl_train
from repro_torch.runtime.async_loop import run_feddct_async
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)


def _net(fl):
    return WirelessNetwork(fl.n_clients, fl.tier_delay_means, fl.delay_std,
                           fl.mu, fl.failure_delay, fl.seed)


def _trainer():
    return SyntheticCohortTrainer(device="cpu")


def _template(seed=0):
    """Mixed-dtype model tree: 2-d f32, bf16 vector, f16 vector, scalar."""
    rng = np.random.default_rng(seed)
    return bridge.from_reference(
        {"w": rng.normal(size=(4, 3)).astype(np.float32),
         "b": rng.normal(size=(5,)).astype(np.float32).astype(
             ml_dtypes.bfloat16),
         "h": rng.normal(size=(3,)).astype(np.float16),
         "s": np.asarray(rng.normal(), np.float32)}, "cpu")


def _int_template_np(seed=0):
    """Float leaves plus every non-float leaf the int32 sidecar carries."""
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(3, 2)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32).astype(
                ml_dtypes.bfloat16),
            "step": np.asarray(rng.integers(0, 1000), np.int32),
            "mask": rng.integers(0, 2, size=(5,)).astype(bool),
            "i8": rng.integers(-128, 128, size=(3,)).astype(np.int8),
            "u16": rng.integers(0, 2 ** 16, size=(2,)).astype(np.uint16),
            "u32": np.asarray([2 ** 31 + 5, 3], np.uint32)}


def _int_template(seed=0):
    return bridge.from_reference(_int_template_np(seed), "cpu")


def _tree_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _hist_equal(ha, hb):
    assert ha.rounds == hb.rounds
    assert ha.times == hb.times
    assert ha.accuracy == hb.accuracy
    assert ha.n_selected == hb.n_selected
    assert ha.n_stragglers == hb.n_stragglers


def _seg_layout(p, rng, max_segs=5):
    """Random contiguous (offset, size) segments covering [0, p)."""
    cuts = sorted(rng.choice(np.arange(1, p), size=min(max_segs - 1,
                                                       p - 1),
                             replace=False).tolist())
    bounds = [0] + cuts + [p]
    return tuple((bounds[i], bounds[i + 1] - bounds[i])
                 for i in range(len(bounds) - 1))


def _sweep_case(rng, max_p=40):
    """Rows with tiny to huge per-segment ranges, one constant segment
    (range 0: the exact path) and ~15 % exact zeros elsewhere."""
    rows, p = int(rng.integers(1, 7)), int(rng.integers(4, max_p))
    segs = _seg_layout(p, rng)
    x = rng.normal(size=(rows, p)).astype(np.float32)
    for off, size in segs:
        x[:, off:off + size] *= 10.0 ** float(rng.integers(-3, 4))
    off0, size0 = segs[0]
    x[:, off0:off0 + size0] = np.float32(rng.normal())
    zmask = rng.random(size=x.shape) < 0.15
    zmask[:, off0:off0 + size0] = False
    x[zmask] = 0.0
    return x, segs, zmask


# ---------------------------------------------------------------------------
# the quantizer: oracle, reference, copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [123, 7, 99])
def test_quantize_rows_property_sweep_matches_ref(seed):
    """Seeded sweep against the numpy oracle: exact parity of q, meta
    and the dequantized rows, the half-step round-trip bound
    ``|x - dq(q(x))| <= scale/2``, exact zeros, exact constant
    segments."""
    rng = np.random.default_rng(seed)
    for case in range(6):
        x, segs, zmask = _sweep_case(rng)
        q, m = quantize_rows(torch.from_numpy(x), segs)
        q, m = q.numpy(), m.numpy()
        qr, mr = quantize_rows_ref(x, segs)
        np.testing.assert_array_equal(q, qr)
        np.testing.assert_array_equal(m, mr)
        dq = dequantize_rows(torch.from_numpy(q), torch.from_numpy(m),
                             segs).numpy()
        np.testing.assert_array_equal(dq, dequantize_rows_ref(q, m, segs))
        assert q.dtype == np.int8 and m.shape == (x.shape[0], 2 * len(segs))
        for j, (off, size) in enumerate(segs):
            scale = m[:, j][:, None]
            err = np.abs(x[:, off:off + size] - dq[:, off:off + size])
            assert (err <= scale * 0.5 * (1 + 1e-4) + 1e-12).all(), \
                f"case {case} seg {j}: round-trip bound violated"
            seg = dequantize_segment(torch.from_numpy(q),
                                     torch.from_numpy(m), segs, j).numpy()
            np.testing.assert_array_equal(seg, dq[:, off:off + size])
        np.testing.assert_array_equal(dq[zmask], 0.0)
        off0, size0 = segs[0]
        np.testing.assert_array_equal(dq[:, off0:off0 + size0],
                                      x[:, off0:off0 + size0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_rows_equals_the_reference_quantizer(seed):
    """The port's quantizer and dequantizer against the reference's
    ``repro.kernels.ops`` on the CPU, on the same rows: exact."""
    rng = np.random.default_rng(seed)
    for _ in range(4):
        x, segs, _ = _sweep_case(rng, max_p=300)
        q, m = quantize_rows(torch.from_numpy(x), segs)
        rq, rm = jax.jit(ref_ops.quantize_rows,
                         static_argnums=(1,))(jnp.asarray(x), segs)
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(m.numpy(), np.asarray(rm))
        dq = dequantize_rows(q, m, segs)
        rdq = ref_ops.dequantize_rows(rq, rm, segs)
        np.testing.assert_array_equal(dq.numpy(), np.asarray(rdq))


def test_oracle_copies_and_constants_equal_the_reference():
    for name in ("quantize_rows_ref", "dequantize_rows_ref"):
        from repro_torch.kernels import ref as port_ref
        assert inspect.getsource(getattr(port_ref, name)) == \
            inspect.getsource(getattr(ref_oracles, name)), name
    assert (QUANT_QMAX, QUANT_STEPS) == (ref_ops.QUANT_QMAX,
                                         ref_ops.QUANT_STEPS)
    rng = np.random.default_rng(4)
    x, segs, _ = _sweep_case(rng)
    for got, want in zip(quantize_rows_ref(x, segs),
                         ref_oracles.quantize_rows_ref(x, segs)):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the quantized store
# ---------------------------------------------------------------------------

def _frow(store, tree):
    row = store.flatten(tree)
    return (row[0] if store.pi else row).numpy()


def test_quant_store_roundtrip_matches_ref_pipeline():
    """Dense quant store: the rows, the meta and what gather returns
    are exactly what the numpy quantize->dequantize oracle predicts,
    for float AND int-sidecar templates (the sidecar stays lossless
    under quant_bits=8)."""
    for tmpl, seed in ((_template, 60), (_int_template, 61)):
        t0, t1 = tmpl(seed), tmpl(seed + 1)
        store = ClientStateStore(t0, 4, quant_bits=8)
        assert store.buffer.dtype == torch.int8
        assert store.bufs[1].shape == (4, 2 * len(store._fsegs))
        store.scatter_params([1], t1)
        row = store.flatten(t1)
        frow = _frow(store, t1)
        q, m = quantize_rows_ref(frow[None], store._fsegs)
        dq = dequantize_rows_ref(q, m, store._fsegs)[0]
        np.testing.assert_array_equal(store.bufs[0][1].numpy(), q[0])
        np.testing.assert_array_equal(store.bufs[1][1].numpy(), m[0])
        dq_t = torch.from_numpy(dq)
        want = store.unflatten((dq_t, row[1]) if store.pi else dq_t)
        _tree_equal(store.gather_one(1), want)
        stacked = store.gather([1, 3, 1])
        for i, c in enumerate([1, 3, 1]):
            _tree_equal({k: v[i] for k, v in stacked.items()},
                        store.gather_one(c))
        got = store.gather_one(1)
        for k, leaf in t1.items():
            if not leaf.dtype.is_floating_point:
                assert torch.equal(got[k], leaf), k
        # untouched rows still serve the (quantized) template
        _tree_equal(store.gather_one(0), store.gather_one(3))


def test_quant_store_error_feedback_residual_and_addback():
    """EF contract: after scatter of row ``x`` the stored residual is
    exactly ``x - dq(q(x))`` of the oracle; the NEXT scatter quantizes
    ``x + ef`` (add-back) and stores the new residual.  EF off keeps no
    state."""
    t0, t1 = _template(70), _template(71)
    store = ClientStateStore(t0, 4, quant_bits=8)
    assert store.error_feedback
    frow = _frow(store, t1)

    store.scatter_params([2], t1)
    q1, m1 = quantize_rows_ref(frow[None], store._fsegs)
    dq1 = dequantize_rows_ref(q1, m1, store._fsegs)[0]
    ef1 = store.ef_residual(2).numpy()
    np.testing.assert_array_equal(ef1, frow - dq1)

    store.scatter_params([2], t1)                  # round 2: same update
    x2 = frow + ef1
    q2, m2 = quantize_rows_ref(x2[None], store._fsegs)
    dq2 = dequantize_rows_ref(q2, m2, store._fsegs)[0]
    np.testing.assert_array_equal(store.ef_residual(2).numpy(), x2 - dq2)
    np.testing.assert_array_equal(store.bufs[0][2].numpy(), q2[0])
    np.testing.assert_array_equal(store.bufs[1][2].numpy(), m2[0])
    assert store.bytes_by_tier()["ef"] == 4 * store.p
    assert store.ef_residual(0) is None

    s2 = ClientStateStore(t0, 4, quant_bits=8, error_feedback=False)
    s2.scatter_params([1], t1)
    assert s2.ef_residual(1) is None
    np.testing.assert_array_equal(s2.bufs[0][1].numpy(), q1[0])
    assert s2.bytes_by_tier()["ef"] == 0


def test_quant_store_merge_scatter_quantizes_every_merged_row():
    """``merge_scatter`` (the window tail) writes each merged client the
    oracle's quantization of the new global row plus that client's own
    residual; duplicate (pad) ids write once."""
    tr = _trainer()
    params = tr.init_params(3)
    store = ClientStateStore(params, 5, quant_bits=8)
    store.scatter_params([0, 2], tr.init_params(4))   # residuals for 0, 2
    ef_before = {c: store.ef_residual(c) for c in (0, 2)}
    ids = [0, 2, 3, 3]
    stacked = store.gather(ids)
    new_params, row = store.merge_scatter(
        ids, stacked, np.asarray([0.5, 0.2, 0.2, 0.1, 0.0], np.float32),
        params)
    frow = row.numpy()
    for c in (0, 2, 3):
        x = frow + (ef_before[c].numpy() if c in ef_before else 0.0)
        q, m = quantize_rows_ref(x[None].astype(np.float32), store._fsegs)
        np.testing.assert_array_equal(store.bufs[0][c].numpy(), q[0])
        np.testing.assert_array_equal(store.bufs[1][c].numpy(), m[0])
        np.testing.assert_array_equal(
            store.ef_residual(c).numpy(),
            x - dequantize_rows_ref(q, m, store._fsegs)[0])


def test_quant_store_validation_and_byte_accounting():
    with pytest.raises(ValueError):
        ClientStateStore(_template(), 4, quant_bits=4)
    with pytest.raises(ValueError):                # needs a float leaf
        ClientStateStore({"step": torch.zeros((), dtype=torch.int32)}, 4,
                         quant_bits=8)
    t = _int_template(80)
    s8 = ClientStateStore(t, 4, quant_bits=8)
    s32 = ClientStateStore(t, 4)
    assert s8.wire_bytes_per_update == wire_bytes(t, 8)
    assert s32.wire_bytes_per_update == wire_bytes(t, 32)
    assert s8.wire_bytes_per_update < s32.wire_bytes_per_update
    b8, b32 = s8.bytes_by_tier(), s32.bytes_by_tier()
    assert b8["hot"] < b32["hot"]
    assert b8["hot"] == 4 * (s8.p + 8 * len(s8._fsegs) + 4 * s8.pi)
    # the reference's formula on the same template
    from repro.core.state import wire_bytes as ref_wire_bytes
    assert s8.wire_bytes_per_update == ref_wire_bytes(
        jax.tree_util.tree_map(jnp.asarray, _int_template_np(80)), 8)


def test_quant32_explicit_is_bit_identical_to_default_matrix():
    """``quant_bits=32`` IS the existing store path: explicit 32 stays
    bit-identical to the default run and the dict reference."""
    fl = FLConfig(n_clients=8, n_tiers=4, tau=2, rounds=4, seed=3)
    base = run_fedasync(_trainer(), _net(fl), fl, window=3, eval_every=4,
                        use_store=True)
    h32 = run_fedasync(_trainer(), _net(fl), fl, window=3, eval_every=4,
                       use_store=True, quant_bits=32)
    hd = run_fedasync(_trainer(), _net(fl), fl, window=3, eval_every=4,
                      use_store=False)
    _hist_equal(base, h32)
    _hist_equal(h32, hd)
    assert h32.meta["quant_bits"] == 32
    assert base.meta == h32.meta

    fl2 = FLConfig(n_clients=8, n_tiers=4, tau=2, rounds=6, mu=0.3,
                   seed=5, beta=1.1)
    a = run_feddct_async(_trainer(), _net(fl2), fl2, use_store=True)
    b = run_feddct_async(_trainer(), _net(fl2), fl2, use_store=True,
                         quant_bits=32)
    _hist_equal(a, b)
    assert a.meta == b.meta


def test_quant8_seeded_deterministic_and_meta():
    """Quantized runs are seeded-deterministic and the meta records
    what ran; the run may differ from f32."""
    fl = FLConfig(n_clients=8, n_tiers=4, tau=2, rounds=6, mu=0.3,
                  seed=5, beta=1.1)
    ha = run_feddct_async(_trainer(), _net(fl), fl, quant_bits=8)
    hb = run_feddct_async(_trainer(), _net(fl), fl, quant_bits=8)
    _hist_equal(ha, hb)
    assert ha.meta == hb.meta
    assert ha.meta["quant_bits"] == 8
    assert ha.meta["error_feedback"] is True
    assert ha.meta["store"] is True
    assert ha.meta["bytes_up"] > 0
    assert ha.meta["store_bytes_ef"] > 0
    hf = run_feddct_async(_trainer(), _net(fl), fl, use_store=True)
    assert ha.meta["wire_bytes_per_update"] \
        < hf.meta["wire_bytes_per_update"]
    assert ha.meta["store_bytes_hot"] < hf.meta["store_bytes_hot"]
    hn = run_feddct_async(_trainer(), _net(fl), fl, quant_bits=8,
                          error_feedback=False)
    assert hn.meta["error_feedback"] is False
    assert hn.meta["store_bytes_ef"] == 0
    # quant8 cannot run without the store (the dict path has no rows)
    with pytest.raises(ValueError):
        run_feddct_async(_trainer(), _net(fl), fl, quant_bits=8,
                         use_store=False)


def test_quant8_forces_the_store_on_a_sequential_loop():
    fl = FLConfig(n_clients=6, n_tiers=3, tau=3, rounds=2, seed=1)
    h = run_fedasync(_trainer(), _net(fl), fl, window=0, eval_every=3,
                     quant_bits=8)
    assert h.meta["store_reason"] == "quant-int8"
    assert h.meta["store_path"] == "store"


@pytest.mark.parametrize("method,kw", [
    ("feddct_async", {}), ("fedbuff", dict(eval_every=2)),
    ("fedasync", dict(window=3, eval_every=2))])
@pytest.mark.parametrize("error_feedback", [True, False],
                         ids=["ef", "no_ef"])
def test_quant8_histories_match_the_reference(method, kw, error_feedback):
    """Whole q8 histories of the synthetic trainer against the
    reference's: the same virtual clock, selections and byte meta, and
    accuracies within one f32 ulp-scale step (the reference's jitted
    quantize and residual may contract ``x - scale*snap`` into an FMA;
    the port's match the oracle exactly)."""
    from repro.config.base import FLConfig as RefFL
    from repro.core import run_method as ref_run
    from repro.fl.network import WirelessNetwork as RefNet
    from repro.fl.testing import SyntheticCohortTrainer as RefSynthetic
    from repro_torch.core import run_method
    fl_kw = dict(n_clients=8, n_tiers=4, tau=2, rounds=6, mu=0.3, seed=5,
                 beta=1.1)
    fl, rfl = FLConfig(**fl_kw), RefFL(**fl_kw)
    got = run_method(method, _trainer(), _net(fl), fl, quant_bits=8,
                     error_feedback=error_feedback, **kw)
    want = ref_run(method, RefSynthetic(),
                   RefNet(rfl.n_clients, rfl.tier_delay_means,
                          rfl.delay_std, rfl.mu, rfl.failure_delay,
                          rfl.seed), rfl, quant_bits=8,
                   error_feedback=error_feedback, **kw)
    g, w = got.to_json(), want.to_json()
    acc_g, acc_w = g.pop("accuracy"), w.pop("accuracy")
    assert g == w
    np.testing.assert_allclose(acc_g, acc_w, rtol=0, atol=1e-6)


def test_error_feedback_cancels_accumulated_quantization_bias():
    """What EF buys: for a slowly drifting row (drift far below the
    grid step) deterministic rounding repeats nearly the same error on
    every write, so the stored rows' accumulated error grows linearly
    without EF; with EF it telescopes to the one outstanding residual."""
    t = _template(90)
    se = ClientStateStore(t, 2, quant_bits=8)
    sn = ClientStateStore(t, 2, quant_bits=8, error_feedback=False)
    frow0 = se.flatten(t).numpy()
    errs_e = np.zeros_like(frow0)
    errs_n = np.zeros_like(frow0)
    for i in range(60):
        x = frow0 * np.float32(1.0 + i * 1e-5)
        for s, errs in ((se, errs_e), (sn, errs_n)):
            s.scatter([0], torch.from_numpy(x))
            dq = dequantize_rows_ref(s.bufs[0][0].numpy()[None],
                                     s.bufs[1][0].numpy()[None],
                                     s._fsegs)[0]
            errs += dq - x
    assert 5.0 * np.abs(errs_e).mean() < np.abs(errs_n).mean()


def test_feddct_async_quant8_cnn_convergence_gate():
    """The quantized-run convergence contract on the reference's own
    seeded CNN task (reduced cnn-mnist, 8 clients, 40 rounds; ~100 s on
    one CPU thread): int8+EF tracks the f32 run within one accuracy
    point (best accuracy over the run), while actually quantizing and
    with EF live, and sends fewer uplink bytes."""
    from repro_torch.config import get_arch
    from repro_torch.fl.client import CNNTrainer
    fl = FLConfig(n_clients=8, n_tiers=2, tau=2, rounds=40, mu=0.0,
                  primary_frac=0.7, seed=0, lr=0.003)

    def trainer():
        return CNNTrainer(get_arch("cnn-mnist").reduced(), fl, "mnist",
                          scale=0.05, device="cpu")

    h32 = run_feddct_async(trainer(), _net(fl), fl, use_store=True)
    h8 = run_feddct_async(trainer(), _net(fl), fl, quant_bits=8)
    h8n = run_feddct_async(trainer(), _net(fl), fl, quant_bits=8,
                           error_feedback=False)
    assert abs(max(h32.accuracy) - max(h8.accuracy)) <= 0.01 + 1e-9
    assert h8.accuracy != h32.accuracy        # quantization is active
    assert h8.accuracy != h8n.accuracy        # error feedback is live
    assert h8.meta["quant_bits"] == 8
    assert h8.meta["bytes_up"] < h32.meta["bytes_up"]


def test_cli_quant_bits_and_no_error_feedback(capsys):
    base = ["--arch", "cnn-mnist", "--method", "fedbuff", "--window", "2",
            "--rounds", "2", "--clients", "4", "--tau", "2", "--device",
            "cpu", "--scale", "0.005"]
    h8 = fl_train.main(base + ["--quant-bits", "8"])
    hn = fl_train.main(base + ["--quant-bits", "8", "--no-error-feedback"])
    h32 = fl_train.main(base + ["--quant-bits", "32"])
    h_default = fl_train.main(base)
    assert (h8.meta["quant_bits"], h8.meta["error_feedback"]) == (8, True)
    assert (hn.meta["quant_bits"], hn.meta["error_feedback"]) == (8, False)
    assert h32.to_json() == h_default.to_json()
    assert h8.meta["bytes_up"] < h32.meta["bytes_up"]
    # the sync methods take no row format: the flag is ignored there
    hs = fl_train.main(["--arch", "cnn-mnist", "--method", "feddct",
                        "--rounds", "1", "--clients", "4", "--tiers", "2",
                        "--tau", "1", "--device", "cpu", "--scale",
                        "0.005", "--quant-bits", "8"])
    assert "quant_bits" not in hs.meta
    assert "[fl_train] fedbuff on cnn-mnist" in capsys.readouterr().out
