"""The port's telemetry (``repro_torch.obs``) against the reference's.

``tests/test_obs.py`` restated for the port (its tiered-residency
cases are in ``tests/test_torch_residency.py``): the no-op default, dual-clock
spans, metrics, caps, both exporters, the validator, the labeled FL
streams and the per-tier report.  On top: tracing on == tracing off for
all seven methods on the CPU, a port trace in both formats accepted by
the REFERENCE's ``repro.obs.validate`` and rendered by its
``repro.obs.report``, the framework-free copies pinned to their
originals, the cohort update norm against the reference's, and the
device-side bookkeeping (CUDA events and observed tensors read back
only at summary time).
"""

from __future__ import annotations

import inspect
import json
import statistics
import time

import numpy as np
import pytest
import torch

from repro.obs import catalogue as ref_catalogue
from repro.obs import flstats as ref_flstats
from repro.obs import report as ref_report
from repro.obs import telemetry as ref_tel
from repro.obs import validate as ref_validate
from repro_torch import obs
from repro_torch.config.base import FLConfig
from repro_torch.core import run_method
from repro_torch.core.tiering import tiering
from repro_torch.fl.network import WirelessNetwork
from repro_torch.fl.testing import SyntheticCohortTrainer
from repro_torch.kernels import _build
from repro_torch.launch import fl_train
from repro_torch.obs import catalogue, flstats
from repro_torch.obs import report as obs_report
from repro_torch.obs import telemetry as obs_tel
from repro_torch.obs import validate as obs_validate
from repro_torch.obs.validate import (sniff_format, validate_chrome,
                                      validate_chrome_file, validate_file,
                                      validate_lines)


def _net(fl):
    return WirelessNetwork(fl.n_clients, fl.tier_delay_means, fl.delay_std,
                           fl.mu, fl.failure_delay, fl.seed)


def _fl(**kw):
    kw.setdefault("n_clients", 8)
    kw.setdefault("n_tiers", 4)
    kw.setdefault("tau", 2)
    kw.setdefault("rounds", 3)
    kw.setdefault("seed", 0)
    return FLConfig(**kw)


def _trainer():
    return SyntheticCohortTrainer(device="cpu")


# ---------------------------------------------------------------------------
# core: disabled default, span recording, metrics
# ---------------------------------------------------------------------------

def test_noop_default_and_restore():
    assert obs_tel.TEL is obs_tel.NOOP
    assert not obs_tel.TEL.enabled
    with obs.tracing() as tel:
        assert obs_tel.TEL is tel
        assert tel.enabled
    assert obs_tel.TEL is obs_tel.NOOP


def test_noop_span_is_shared_and_inert():
    s1 = obs_tel.NOOP.span("a", x=1)
    s2 = obs_tel.NOOP.span("b")
    assert s1 is s2                       # no per-call allocation
    with s1:
        pass
    s1.start().set(y=2).end()             # manual API is also a no-op
    obs_tel.NOOP.inc("c")
    obs_tel.NOOP.gauge("g", 1.0)
    obs_tel.NOOP.observe("h", 1.0)
    obs_tel.NOOP.set_virtual_time(5.0)
    meta = {}
    obs_tel.NOOP.summarize_into(meta)
    assert meta == {}                     # disabled runs never touch meta


def test_disabled_overhead_under_noise_floor():
    """The disabled hot-path cost (attribute lookup + no-op span) sits at
    sub-microsecond scale.  The median over many short trials of
    (instrumented - bare) loop time keeps the reading steady when other
    test workers share the cores."""
    n, trials = 2_000, 41

    def bare():
        t0 = time.perf_counter()
        for _ in range(n):
            pass
        return time.perf_counter() - t0

    def instrumented():
        t0 = time.perf_counter()
        for _ in range(n):
            with obs_tel.TEL.span("x"):
                pass
        return time.perf_counter() - t0

    diffs = [instrumented() - bare() for _ in range(trials)]
    per_call_us = statistics.median(diffs) / n * 1e6
    assert per_call_us < 10.0, f"disabled span costs {per_call_us:.2f}us"


def test_span_records_wall_and_virtual_time():
    with obs.tracing() as tel:
        tel.set_virtual_time(10.0)
        with tel.span("work", rows=4):
            time.sleep(0.01)
            tel.set_virtual_time(25.0)
    (s,) = tel.spans
    assert s["name"] == "work"
    assert s["args"] == {"rows": 4}
    assert s["dur_us"] >= 10_000          # slept 10 ms of host time
    assert s["vt0"] == 10.0 and s["vt1"] == 25.0
    # no CUDA device: no event was recorded, the device time is None
    assert s["dev_us"] is None
    assert tel.summary()["spans"]["work"]["dev_total_s"] is None


def test_manual_span_and_metrics_summary():
    with obs.tracing() as tel:
        sp = tel.span("phase", k=1).start()
        tel.inc("hits")
        tel.inc("hits", 2)
        tel.gauge("depth", 3)
        tel.gauge("depth", 7)
        for v in (1.0, 2.0, 3.0, 4.0):
            tel.observe("cohort.size", v)
        sp.end()
        tel.inc("lookahead.hit", 3)
        tel.inc("lookahead.miss", 1)
    s = tel.summary()
    assert s["spans"]["phase"]["count"] == 1
    assert s["counters"]["hits"] == 3
    assert s["gauges"]["depth"] == 7.0
    h = s["hists"]["cohort.size"]
    assert h["count"] == 4 and h["mean"] == 2.5 and h["max"] == 4.0
    assert s["rates"]["lookahead_accuracy"] == 0.75
    meta = {}
    tel.summarize_into(meta)
    assert meta["telemetry"]["counters"]["hits"] == 3


def test_span_cap_counts_drops():
    with obs.tracing() as tel:
        old = obs_tel.MAX_SPANS
        obs_tel.MAX_SPANS = 2
        try:
            for _ in range(5):
                with tel.span("x"):
                    pass
        finally:
            obs_tel.MAX_SPANS = old
    assert len(tel.spans) == 2
    assert tel.counters["telemetry.dropped_spans"] == 3


def test_observed_tensors_resolve_only_at_summary():
    """A tensor handed to ``observe`` is kept as it is (no readback at
    the call) and becomes a float when the summary resolves it."""
    on_device = torch.tensor(3.0)
    with obs.tracing() as tel:
        tel.observe("fl.cohort.update_norm", on_device)
        tel.observe("fl.cohort.update_norm", 4.0)
        assert isinstance(tel.hists["fl.cohort.update_norm"][0],
                          torch.Tensor)
        assert len(tel._pending_obs) == 1
    h = tel.summary()["hists"]["fl.cohort.update_norm"]
    assert h["count"] == 2 and h["mean"] == 3.5
    assert tel.hists["fl.cohort.update_norm"] == [3.0, 4.0]
    assert tel._pending_obs == [] and tel._pending_spans == []


def test_traced_run_resolves_device_values_once_at_its_end(monkeypatch):
    """Device values are read back only by ``summary``/export: a traced
    run resolves once, when it folds its summary into the meta."""
    calls = []
    real = obs_tel.Telemetry.resolve

    def counting(self):
        calls.append(len(self.spans))
        return real(self)

    monkeypatch.setattr(obs_tel.Telemetry, "resolve", counting)
    fl = _fl(rounds=3)
    with obs.tracing() as tel:
        run_method("feddct_async", _trainer(), _net(fl), fl)
    assert calls == [len(tel.spans)]


# ---------------------------------------------------------------------------
# exporters + validators (the port's, and the reference's on port traces)
# ---------------------------------------------------------------------------

def _tiny_trace():
    with obs.tracing() as tel:
        tel.set_virtual_time(1.0)
        with tel.span("run", method="t"):
            with tel.span("window.merge", cohort=2):
                pass
        tel.inc("drain.count")
        tel.gauge("queue.depth", 5)
        tel.observe("cohort.size", 2)
    return tel


def test_jsonl_export_validates(tmp_path):
    tel = _tiny_trace()
    p = str(tmp_path / "t.jsonl")
    assert tel.export_jsonl(p) == p
    for validate in (validate_file, ref_validate.validate_file):
        errors, counts = validate(p)
        assert errors == []
        assert counts["meta"] == 1 and counts["summary"] == 1
        assert counts["span"] == 2
    with open(p) as f:
        first = json.loads(f.readline())
        spans = [json.loads(l) for l in f if '"type": "span"' in l]
    assert first["type"] == "meta"
    assert first["schema_version"] == obs.SCHEMA_VERSION
    assert first["torch"] == torch.__version__
    assert first["backend"] == "cpu" and first["device_count"] == 1
    assert all("dev_us" in s and s["dev_us"] is None for s in spans)


def test_validator_rejects_corrupt_traces():
    errors, _ = validate_lines(["not json at all"])
    assert any("not JSON" in e for e in errors)
    meta = json.dumps({"type": "meta",
                       "schema_version": obs.SCHEMA_VERSION,
                       "clock": "perf_counter_us"})
    span = json.dumps({"type": "span", "name": "x", "ts_us": 0.0,
                       "dur_us": 1.0, "vt0": 0, "vt1": 0, "args": {}})
    summ = json.dumps({"type": "summary", "wall_s": 0.1, "spans": {},
                       "counters": {}})
    # happy path
    assert validate_lines([meta, span, summ])[0] == []
    # meta not first
    assert validate_lines([span, meta, summ])[0]
    # missing required span key
    bad = json.dumps({"type": "span", "name": "x"})
    assert any("missing" in e for e in validate_lines([meta, bad, summ])[0])
    # unknown record type
    unk = json.dumps({"type": "mystery"})
    assert any("unknown" in e for e in validate_lines([meta, span, unk,
                                                       summ])[0])
    # wrong schema version
    old = json.dumps({"type": "meta", "schema_version": 99,
                      "clock": "perf_counter_us"})
    assert any("schema_version" in e
               for e in validate_lines([old, span, summ])[0])


def test_chrome_export_shape(tmp_path):
    tel = _tiny_trace()
    p = str(tmp_path / "t.json")
    tel.export_chrome(p)
    doc = json.load(open(p))
    events = doc["traceEvents"]
    xs = [e for e in events if e["ph"] == "X"]
    assert {e["name"] for e in xs} == {"run", "window.merge"}
    for e in xs:
        assert e["ts"] >= 0 and e["dur"] >= 0
        assert "vt0" in e["args"] and "vt1" in e["args"]
        assert e["args"]["dev_us"] is None
    assert any(e["ph"] == "C" and e["name"] == "queue.depth"
               for e in events)
    assert doc["otherData"]["schema_version"] == obs.SCHEMA_VERSION
    assert doc["otherData"]["counters"]["drain.count"] == 1


def test_chrome_validator(tmp_path):
    tel = _tiny_trace()
    p = str(tmp_path / "t.json")
    tel.export_chrome(p)
    for validate in (validate_chrome_file, ref_validate.validate_chrome_file):
        errors, counts = validate(p)
        assert errors == []
        assert counts["X"] == 2 and counts["M"] == 2
    assert sniff_format(p) == "chrome"
    jp = str(tmp_path / "t.jsonl")
    tel.export_jsonl(jp)
    assert sniff_format(jp) == "jsonl"


def test_chrome_validator_rejects_corrupt():
    assert validate_chrome([])[0]                       # not an object
    assert any("traceEvents" in e for e in validate_chrome({})[0])
    ok = {"traceEvents": [
        {"name": "x", "ph": "X", "pid": 0, "tid": 0, "ts": 0.0,
         "dur": 1.0, "args": {"vt0": 0.0, "vt1": 0.0}}],
        "otherData": {"schema_version": obs.SCHEMA_VERSION,
                      "counters": {},
                      "summary": {"wall_s": 0.1, "spans": {},
                                  "counters": {}}}}
    assert validate_chrome(ok)[0] == []
    # X span without the virtual-time interval
    bad = json.loads(json.dumps(ok))
    bad["traceEvents"][0]["args"] = {}
    assert any("vt0" in e for e in validate_chrome(bad)[0])
    # wrong schema version
    bad = json.loads(json.dumps(ok))
    bad["otherData"]["schema_version"] = 99
    assert any("schema_version" in e for e in validate_chrome(bad)[0])
    # no spans at all
    bad = json.loads(json.dumps(ok))
    bad["traceEvents"] = []
    assert any("no spans" in e for e in validate_chrome(bad)[0])
    # summary missing required keys
    bad = json.loads(json.dumps(ok))
    bad["otherData"]["summary"] = {}
    assert any("summary missing" in e for e in validate_chrome(bad)[0])


@pytest.mark.parametrize("fmt", ["jsonl", "chrome"])
def test_cli_trace_passes_the_reference_validator_and_report(tmp_path, fmt,
                                                             capsys):
    """``fl_train --trace`` on the CPU: the trace passes the reference's
    ``python -m repro.obs.validate`` (its ``main``) and the port's, and
    renders through the reference's ``repro.obs.report`` and the
    port's; ``--report PATH`` writes the structured report."""
    trace = str(tmp_path / ("t.jsonl" if fmt == "jsonl" else "t.json"))
    rep_path = str(tmp_path / "rep.json")
    hist = fl_train.main(["--arch", "cnn-mnist", "--method", "feddct",
                          "--rounds", "2", "--clients", "4", "--tiers", "2",
                          "--tau", "1", "--device", "cpu", "--trace", trace,
                          "--trace-format", fmt, "--report", rep_path])
    out = capsys.readouterr().out
    assert f"[fl_train] trace ({fmt}) -> {trace}" in out
    assert "FL run report" in out
    assert "telemetry" in hist.meta
    assert ref_validate.main([trace]) == 0
    assert obs_validate.main([trace]) == 0
    assert ref_report.main([trace]) == 0
    assert obs_report.main([trace]) == 0
    summary, _ = ref_report.load_source(trace)
    assert set(summary["spans"]) >= {"run", "round.select", "round.train",
                                     "round.aggregate", "eval"}
    rep = json.load(open(rep_path))
    assert rep["rounds"] == 2 and rep["tiers"]
    assert rep["trajectory"]["evals"] == len(hist.accuracy)


# ---------------------------------------------------------------------------
# numerical invisibility: tracing must not change any history
# ---------------------------------------------------------------------------

CASES = [
    ("fedasync", dict(window=3, eval_every=2)),
    ("fedbuff", dict(eval_every=2)),
    ("feddct_async", dict()),
    ("feddct", dict()),
    ("fedavg", dict()),
    ("tifl", dict()),
    ("fedprox", dict()),
]


@pytest.mark.parametrize("method,kw", CASES, ids=[c[0] for c in CASES])
def test_tracing_is_numerically_invisible(method, kw):
    """Bit-identical RunHistories with tracing on vs off; the traced
    meta differs ONLY by the additive ``telemetry`` block."""
    fl = _fl()
    h_off = run_method(method, _trainer(), _net(fl), fl, **kw)
    with obs.tracing():
        h_on = run_method(method, _trainer(), _net(fl), fl, **kw)
    assert h_on.times == h_off.times
    assert h_on.rounds == h_off.rounds
    assert h_on.accuracy == h_off.accuracy
    assert h_on.tier == h_off.tier
    assert h_on.n_selected == h_off.n_selected
    assert "telemetry" not in h_off.meta
    on_meta = dict(h_on.meta)
    assert on_meta.pop("telemetry")["spans"]["run"]["count"] == 1
    assert on_meta == h_off.meta


def test_sync_loops_record_uniform_execution_meta():
    fl = _fl(rounds=2)
    for method in ("feddct", "fedavg", "tifl", "fedprox"):
        h = run_method(method, _trainer(), _net(fl), fl)
        assert h.meta["kernel_agg"] is False, method
        assert h.meta["mesh_devices"] == 1, method


def test_sync_loop_traced_summary():
    fl = _fl(rounds=2)
    with obs.tracing():
        h = run_method("feddct", _trainer(), _net(fl), fl)
    t = h.meta["telemetry"]
    assert t["spans"]["run"]["count"] == 1
    assert "round.train" in t["spans"]
    assert "round.select" in t["spans"]
    # virtual clock advanced: the run span covers simulated time
    assert t["spans"]["run"]["total_vt"] > 0


def test_traced_port_run_matches_the_reference_streams():
    """The same seeded run traced in both packages records the same
    span names and counts, and the same FL counters and gauges."""
    from repro.config.base import FLConfig as RefFL
    from repro.core import run_method as ref_run
    from repro.fl.network import WirelessNetwork as RefNet
    from repro.fl.testing import SyntheticCohortTrainer as RefSynthetic
    kw = dict(n_clients=8, n_tiers=4, tau=2, rounds=4, seed=0)
    for method in ("feddct", "feddct_async", "fedbuff"):
        fl, rfl = FLConfig(**kw), RefFL(**kw)
        with obs.tracing():
            got = run_method(method, _trainer(), _net(fl), fl)
        with ref_tel.tracing():
            want = ref_run(method, RefSynthetic(),
                           RefNet(rfl.n_clients, rfl.tier_delay_means,
                                  rfl.delay_std, rfl.mu, rfl.failure_delay,
                                  rfl.seed), rfl)
        g, w = got.meta["telemetry"], want.meta["telemetry"]
        assert ({k: v["count"] for k, v in g["spans"].items()}
                == {k: v["count"] for k, v in w["spans"].items()}), method
        assert g["gauges"] == w["gauges"], method
        # the reference also counts its compiles (``jax.*``) and its
        # store's donation mode; the port builds no programs in a run
        # and its store writes in place
        skip = ("jax.", "store.donation_")
        wc = {k: v for k, v in w["counters"].items()
              if not k.startswith(skip)}
        assert g["counters"] == wc, method
        wh = {k: v["count"] for k, v in w["hists"].items()
              if not k.startswith(skip)}
        assert {k: v["count"] for k, v in g["hists"].items()} == wh, method


# ---------------------------------------------------------------------------
# flstats: labeled FL-semantic streams
# ---------------------------------------------------------------------------

def test_label_roundtrip():
    assert flstats.label("fl.tier.size") == "fl.tier.size"
    name = flstats.label("fl.tier.migration", to=2, **{"from": 1})
    assert name == "fl.tier.migration{from=1,to=2}"   # sorted keys
    base, labels = flstats.parse_label(name)
    assert base == "fl.tier.migration"
    assert labels == {"from": "1", "to": "2"}
    assert flstats.parse_label("plain.counter") == ("plain.counter", {})


def test_flstats_disabled_is_inert():
    """Every record_* early-returns on the NOOP singleton (which has
    __slots__, so any state leak would raise)."""
    assert obs_tel.TEL is obs_tel.NOOP
    flstats.record_tiering([[0, 1]], thresholds=[1.0], population=2)
    flstats.record_selection([(0, 0), 1])
    flstats.record_response(1, 1.0, 2.0, timed_out=False)
    flstats.record_staleness([1, 2], [1, None])
    flstats.record_straggler("dropped", tier=1)
    flstats.record_client_updates([0, 1])
    flstats.record_uplink(64, tier=1)
    flstats.record_update_norm(None, 0)
    flstats.record_update_norm({"w": torch.ones(2, 3)}, 2)


def test_flstats_cardinality_cap(monkeypatch):
    monkeypatch.setattr(flstats, "MAX_LABELS_PER_METRIC", 2)
    with obs.tracing() as tel:
        for t in range(5):
            flstats.record_response(t + 1, 1.0, 2.0, timed_out=False)
    admitted = [k for k in tel.hists if k.startswith("fl.response_s{")]
    assert len(admitted) == 2
    assert tel.counters[flstats.DROPPED] > 0
    # a fresh tracing block starts a fresh label budget
    with obs.tracing() as tel2:
        flstats.record_response(9, 1.0, 2.0, timed_out=False)
    assert "fl.response_s{tier=9}" in tel2.hists
    assert flstats.DROPPED not in tel2.counters


def test_flstats_migration_matrix_seeded_drift():
    """A deterministic drifting-response scenario produces the
    hand-checked migration-matrix entries and per-tier threshold series
    (client 0 then client 1 slow down and sink from tier 1 to tier 2,
    displacing the fast ones upward)."""
    from repro_torch.core.selection import tier_timeouts
    ats = [
        {0: 1.0, 1: 2.0, 2: 3.0, 3: 4.0},   # [[0,1],[2,3]]
        {0: 5.0, 1: 2.0, 2: 3.0, 3: 4.0},   # [[1,2],[3,0]]
        {0: 5.0, 1: 6.0, 2: 3.0, 3: 4.0},   # [[2,3],[0,1]]
    ]
    with obs.tracing() as tel:
        for at in ats:
            tiers = tiering(at, 2)
            flstats.record_tiering(
                tiers, thresholds=tier_timeouts(tiers, at, beta=2.0,
                                                omega=100.0),
                population=4)
    c = tel.counters
    assert c["fl.tier.migration{from=1,to=2}"] == 2
    assert c["fl.tier.migration{from=2,to=1}"] == 2
    assert c["fl.tier.rounds"] == 3
    assert tel.gauges["fl.population"] == 4.0
    for t in (1, 2):
        assert len(tel.gauge_series[f"fl.tier.size{{tier={t}}}"]) == 3
        assert len(tel.gauge_series[f"fl.tier.threshold_s{{tier={t}}}"]) == 3
    # Eq. 7 thresholds (beta * tier mean): hand-computed series
    assert tel.hists["fl.threshold_s{tier=1}"] == [3.0, 5.0, 7.0]
    assert tel.hists["fl.threshold_s{tier=2}"] == [7.0, 9.0, 11.0]


def test_flstats_response_and_straggler_streams():
    with obs.tracing() as tel:
        flstats.record_response(1, 3.0, 4.0, timed_out=False)
        flstats.record_response(1, 5.0, 4.0, timed_out=True)
        flstats.record_response(2, 8.0, 10.0, timed_out=False)
        flstats.record_straggler("dropped", tier=1)
        flstats.record_straggler("carried", tier=2, n=2)
        flstats.record_staleness([0, 3], [1, 2])
        flstats.record_selection([(4, 0), (5, 1), 6], population=8)
        flstats.record_client_updates([4, 5])
    c = tel.counters
    assert c["fl.tier.participate{tier=1}"] == 1
    assert c["fl.tier.timeout{tier=1}"] == 1
    assert c["fl.tier.participate{tier=2}"] == 1
    assert c["fl.straggler.dropped{tier=1}"] == 1
    assert c["fl.straggler.carried{tier=2}"] == 2
    assert c["fl.tier.selected{tier=1}"] == 1
    assert c["fl.tier.selected{tier=2}"] == 1
    assert c["fl.client.selected{client=6}"] == 1
    assert c["fl.client.update{client=4}"] == 1
    assert tel.hists["fl.response_s{tier=1}"] == [3.0, 5.0]
    assert tel.hists["fl.response_frac{tier=1}"] == [0.75, 1.25]
    assert tel.hists["fl.staleness"] == [0.0, 3.0]
    assert tel.hists["fl.staleness{tier=2}"] == [3.0]
    assert tel.gauges["fl.population"] == 8.0


def test_update_norm_matches_the_reference():
    """The cohort update norm, summed on the device in f32, against the
    reference's (f64 host sum of f32 leaf sums) on the same rows; the
    pad rows past ``n_rows`` are left out by both."""
    import jax.numpy as jnp
    rng = np.random.default_rng(5)
    rows = {"a": rng.normal(size=(4, 3, 5)).astype(np.float32),
            "b": rng.normal(size=(4, 7)).astype(np.float32)}
    with obs.tracing() as tel:
        flstats.record_update_norm(
            {k: torch.from_numpy(v) for k, v in rows.items()}, 3)
        (pending,) = tel.hists["fl.cohort.update_norm"]
        assert isinstance(pending, torch.Tensor)      # not read back yet
    with ref_tel.tracing() as ref:
        ref_flstats.record_update_norm(
            {k: jnp.asarray(v) for k, v in rows.items()}, 3)
    got = tel.summary()["hists"]["fl.cohort.update_norm"]["mean"]
    want = ref.summary()["hists"]["fl.cohort.update_norm"]["mean"]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    exact = np.sqrt(sum(float((v[:3].astype(np.float64) ** 2).sum())
                        for v in rows.values()))
    np.testing.assert_allclose(got, exact, rtol=1e-6)


# ---------------------------------------------------------------------------
# report: per-tier run report from traces / histories
# ---------------------------------------------------------------------------

def _traced_async_run(fl=None, **kw):
    fl = fl or _fl(rounds=4)
    with obs.tracing() as tel:
        hist = run_method("feddct_async", _trainer(), _net(fl), fl, **kw)
    return fl, tel, hist


def test_flstats_report_acceptance_feddct_async():
    """A traced feddct_async run yields a report with per-tier
    participation counts, timeout-hit rates, and the migration matrix,
    all consistent with the raw counters."""
    fl, tel, hist = _traced_async_run()
    t = hist.meta["telemetry"]
    c = t["counters"]
    rep = obs_report.build_report(t, hist.to_json())

    assert rep["rounds"] == c["fl.tier.rounds"] > 0
    assert rep["population"] == fl.n_clients
    assert rep["tiers"], "per-tier table is empty"
    for tier, row in rep["tiers"].items():
        assert row["selected"] == c.get(f"fl.tier.selected{{tier={tier}}}",
                                        0)
        seen = row["participated"] + row["timeout_hits"]
        if seen:
            assert row["timeout_hit_rate"] == pytest.approx(
                row["timeout_hits"] / seen)
        if "mean_response_s" in row:
            assert row["mean_response_s"] > 0
    total_sel = sum(r["selected"] for r in rep["tiers"].values())
    client_sel = sum(v for k, v in c.items()
                     if k.startswith("fl.client.selected{"))
    assert total_sel == client_sel > 0
    mig = sum(v for k, v in c.items()
              if k.startswith("fl.tier.migration{"))
    assert rep["n_migrations"] == mig
    f = rep["fairness"]["selection"]
    assert f["population"] == fl.n_clients
    assert 0.0 <= f["gini"] <= 1.0
    assert 0.0 < f["coverage"] <= 1.0
    assert "fl.staleness" in t["hists"]
    assert "cohort_update_norm" in rep
    assert rep["trajectory"]["evals"] == len(hist.accuracy)
    text = obs_report.format_report(rep, source="test")
    for tier in rep["tiers"]:
        assert f"\n{tier:>4}  " in text or str(tier) in text
    # the reference's report builds the same table from the port's run
    assert ref_report.build_report(t, hist.to_json()) == rep


def test_report_sources_agree(tmp_path):
    """The three report sources (JSONL trace, chrome trace, RunHistory
    JSON) produce the same per-tier table."""
    _, tel, hist = _traced_async_run()
    jp = str(tmp_path / "t.jsonl")
    cp = str(tmp_path / "t.json")
    hp = str(tmp_path / "h.json")
    tel.export_jsonl(jp)
    tel.export_chrome(cp)
    hist.save(hp)
    reports = []
    for p in (jp, cp, hp):
        summary, history = obs_report.load_source(p)
        assert summary is not None, p
        reports.append(obs_report.build_report(summary, history))
    assert reports[0]["tiers"] == reports[1]["tiers"] == reports[2]["tiers"]
    assert (reports[0]["migration_matrix"]
            == reports[1]["migration_matrix"]
            == reports[2]["migration_matrix"])
    assert "trajectory" not in reports[0]
    assert reports[2]["trajectory"]["evals"] == len(hist.accuracy)


def test_report_cli(tmp_path, capsys):
    _, tel, hist = _traced_async_run()
    jp = str(tmp_path / "t.jsonl")
    tel.export_jsonl(jp)
    out_json = str(tmp_path / "rep.json")
    assert obs_report.main([jp, "--json", out_json]) == 0
    text = capsys.readouterr().out
    assert "FL run report" in text
    rep = json.load(open(out_json))
    assert rep["tiers"]
    # an untraced input is a clean exit-2 diagnostic, not a crash
    hp = str(tmp_path / "h.json")
    hist.meta.pop("telemetry")
    hist.save(hp)
    assert obs_report.main([hp]) == 2
    bogus = str(tmp_path / "x.json")
    with open(bogus, "w") as f:
        f.write("{not json")
    assert obs_report.main([bogus]) == 2


def test_trace_format_parity(tmp_path):
    """The aggregate folded into ``RunHistory.meta["telemetry"]`` is
    identical to what BOTH export formats embed (only ``wall_s``
    differs — it is stamped at export time)."""
    _, tel, hist = _traced_async_run()
    jp = str(tmp_path / "t.jsonl")
    cp = str(tmp_path / "t.json")
    tel.export_jsonl(jp)
    tel.export_chrome(cp)
    with open(jp) as f:
        jsonl_summary = [json.loads(l) for l in f if l.strip()][-1]
    assert jsonl_summary.pop("type") == "summary"
    chrome_summary = json.load(open(cp))["otherData"]["summary"]
    meta_summary = hist.meta["telemetry"]
    for key in ("spans", "counters", "gauges", "hists"):
        assert jsonl_summary[key] == meta_summary[key], key
        assert chrome_summary[key] == meta_summary[key], key
    assert jsonl_summary.get("rates") == meta_summary.get("rates") \
        == chrome_summary.get("rates")


# ---------------------------------------------------------------------------
# the copies, pinned to their originals
# ---------------------------------------------------------------------------

def _as_port(text: str) -> str:
    return (text.replace("repro.obs", "repro_torch.obs")
            .replace("repro.core", "repro_torch.core"))


@pytest.mark.parametrize("port,ref", [(obs_validate, ref_validate),
                                      (obs_report, ref_report)],
                         ids=["validate", "report"])
def test_framework_free_copies_equal_the_reference(port, ref):
    assert inspect.getsource(port) == _as_port(inspect.getsource(ref))


def test_flstats_copy_equals_the_reference_but_the_update_norm():
    """Every function of ``flstats`` but ``record_update_norm`` (summed
    on the device, read back at summary time) is the reference's."""
    names = [n for n, f in inspect.getmembers(ref_flstats,
                                              inspect.isfunction)
             if f.__module__ == ref_flstats.__name__]
    assert "record_update_norm" in names and len(names) > 10
    for name in names:
        if name == "record_update_norm":
            continue
        assert inspect.getsource(getattr(flstats, name)) == _as_port(
            inspect.getsource(getattr(ref_flstats, name))), name
    for const in ("MAX_LABELS_PER_METRIC", "MAX_CLIENT_LABELS",
                  "_CLIENT_METRICS", "DROPPED"):
        assert getattr(flstats, const) == getattr(ref_flstats, const)


def test_catalogue_copy_differs_only_in_the_build_names():
    """The reference's catalogue, with ``jax.compiles`` /
    ``jax.compile_s`` / the ``jax.cache.`` prefix replaced by the port's
    ``kernel.builds`` / ``kernel.build_s``, and nothing else."""
    assert catalogue.SPANS == ref_catalogue.SPANS
    assert catalogue.GAUGES == ref_catalogue.GAUGES
    assert catalogue.COUNTERS == (ref_catalogue.COUNTERS
                                  - {"jax.compiles"} | {"kernel.builds"})
    assert catalogue.HISTS == (ref_catalogue.HISTS
                               - {"jax.compile_s"} | {"kernel.build_s"})
    assert catalogue.COUNTER_PREFIXES == tuple(
        p for p in ref_catalogue.COUNTER_PREFIXES if p != "jax.cache.")
    assert catalogue.ALL == (ref_catalogue.ALL
                             - {"jax.compiles", "jax.compile_s"}
                             | {"kernel.builds", "kernel.build_s"})
    assert inspect.getsource(catalogue.kind_of) == inspect.getsource(
        ref_catalogue.kind_of)
    assert catalogue.kind_of("kernel.builds") == "counter"
    assert catalogue.kind_of("kernel.build_s") == "hist"
    assert catalogue.kind_of("jax.cache.hits") == "unknown"
    assert catalogue.kind_of("fl.response_s{tier=3}") == "hist"


def test_telemetry_surface_equals_the_reference():
    assert obs.__all__ == ["NOOP", "SCHEMA_VERSION", "NoopTelemetry",
                           "Telemetry", "disable", "enable", "tracing"]
    assert obs.SCHEMA_VERSION == ref_tel.SCHEMA_VERSION
    for cap in ("MAX_SPANS", "MAX_SERIES", "MAX_HIST"):
        assert getattr(obs_tel, cap) == getattr(ref_tel, cap)


def test_recorded_names_are_catalogued():
    """Every stream a traced run of every method records is in the
    port's catalogue."""
    fl = _fl(rounds=3)
    with obs.tracing() as tel:
        for method, kw in CASES:
            run_method(method, _trainer(), _net(fl), fl, **kw)
    kinds = ([("span", s["name"]) for s in tel.spans]
             + [("counter", n) for n in tel.counters]
             + [("gauge", n) for n in tel.gauges]
             + [("hist", n) for n in tel.hists])
    assert kinds
    for kind, name in kinds:
        assert catalogue.kind_of(name) == kind, (kind, name)


# ---------------------------------------------------------------------------
# kernel builds: counted while tracing, and only then
# ---------------------------------------------------------------------------

class _FakeNvcc:
    """``subprocess.Popen`` stand-in: writes the output file nvcc would."""

    def __init__(self, cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"")
        self.returncode = 0

    def communicate(self):
        return "", None


def test_kernel_builds_are_counted_only_while_tracing(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", _FakeNvcc)
    _build.build(["fedagg"])                    # untraced: nothing kept
    with obs.tracing() as tel:
        _build.build(["fedagg"])                # library exists: no build
        assert "kernel.builds" not in tel.counters
        for t in tmp_path.iterdir():
            t.unlink()
        _build.build(["fedagg", "ssm_scan"])    # two sources, one nvcc each
    assert tel.counters["kernel.builds"] == 2
    (h,) = [tel.summary()["hists"]["kernel.build_s"]]
    assert h["count"] == 2 and h["max"] >= 0.0
