"""The port's selective scan (kernel K5's plain twin and wrapper,
``models/ssm.py``) against the JAX package's, on the same numpy inputs.

Tolerances are the reference's own tests': 1e-4 (f32) and 5e-2 (bf16)
for the kernel's function (``tests/test_kernels.py``), 1e-4 for
``ssm_core`` and 2e-4 for the layer's prefill-to-decode handoff
(``tests/test_recurrent.py``): f32 recurrences summed in another order
(a sequential scan against the reference's associative one).  On the
CPU the wrapper is its plain twin; that ``ssm_core`` is one kernel call
on the card, with strided B/C views and the carried state, is checked
here by routing, and the kernel itself is held against the twin on the
card by ``chip_smoke.py``.  The kernel's arithmetic order (time split
into segments scanned from a zero state, carries folded in order, each
segment rerun from its carry; exps as exp2 of dt * A * log2 e) is
emulated here in plain torch and held against the reference at the
f32 tolerance, 1e-4.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ssm_scan_op as ref_ssm_scan_op
from repro.kernels.ref import ssm_scan_ref
from repro.models import ssm as ref_ssm
from repro_torch import bridge
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ssm_scan as ss
from repro_torch.models import ssm

torch.set_num_threads(1)


def _inputs(seed, b, s, d, n):
    """x, dt (softplus of a normal), b_in, c_out, a_log = log(1..n)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, d)), 0.0).astype(np.float32)
    b_in = rng.standard_normal((b, s, n)).astype(np.float32)
    c_out = rng.standard_normal((b, s, n)).astype(np.float32)
    a_log = np.repeat(np.log(np.arange(1, n + 1, dtype=np.float32))[None],
                      d, 0)
    return x, dt, b_in, c_out, a_log


def _pt(arrays):
    return [bridge.to_torch(a, "cpu") for a in arrays]


def _jx(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("b,s,d,n,chunk,bd", [
    (2, 64, 32, 8, 16, 16),
    (1, 128, 64, 16, 32, 64),
    (3, 32, 16, 4, 32, 8),
])
def test_ssm_scan_plain_matches_pallas_kernel(b, s, d, n, chunk, bd):
    arrays = _inputs(s + d, b, s, d, n)
    want = ref_ssm_scan_op(*_jx(arrays), chunk=chunk, block_d=bd,
                           interpret=True)
    oracle = ssm_scan_ref(*_jx(arrays))
    y, h_end = ss.ssm_scan_plain(*_pt(arrays))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(y.numpy(), np.asarray(oracle), rtol=1e-4,
                               atol=1e-4)
    assert h_end.dtype == torch.float32 and tuple(h_end.shape) == (b, d, n)
    # the wrapper and the op are the twin on the CPU
    y_w, h_w = ss.ssm_scan(*_pt(arrays))
    assert torch.equal(y_w, y) and torch.equal(h_w, h_end)
    y_op = kernel_ops.ssm_scan_op(*_pt(arrays))
    assert torch.equal(y_op, y)


def test_ssm_scan_plain_bf16():
    arrays = list(_inputs(7, 2, 64, 32, 8))
    for i in range(4):
        arrays[i] = arrays[i].astype(ml_dtypes.bfloat16)
    want = ref_ssm_scan_op(*_jx(arrays), chunk=16, block_d=16,
                           interpret=True)
    y, _ = ss.ssm_scan_plain(*_pt(arrays))
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), np.asarray(want,
                                                             np.float32),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("split", [1, 17, 40])
def test_h0_in_and_h_end_out_match_the_reference_core(split):
    """A scan from the state another scan ended in is the whole scan;
    y and h_end equal the reference's ``ssm_core`` with that h0."""
    b, s, d, n = 2, 48, 24, 8
    x, dt, b_in, c_out, a_log = _inputs(split, b, s, d, n)
    y_all, h_all = ss.ssm_scan_plain(*_pt((x, dt, b_in, c_out, a_log)))
    first = [a[:, :split] for a in (x, dt, b_in, c_out)]
    rest = [a[:, split:] for a in (x, dt, b_in, c_out)]
    y_a, h_a = ss.ssm_scan_plain(*_pt(first), bridge.to_torch(a_log, "cpu"))
    y_b, h_b = ss.ssm_scan_plain(*_pt(rest), bridge.to_torch(a_log, "cpu"),
                                 h_a)
    np.testing.assert_allclose(torch.cat([y_a, y_b], 1).numpy(),
                               y_all.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h_b.numpy(), h_all.numpy(), rtol=1e-5,
                               atol=1e-5)
    bc = np.concatenate([rest[2], rest[3]], -1)
    want_y, want_h = ref_ssm.ssm_core(
        {"A_log": jnp.asarray(a_log)}, jnp.asarray(rest[0]),
        jnp.asarray(rest[1]), jnp.asarray(bc), jnp.asarray(h_a.numpy()), n,
        chunk=8)
    np.testing.assert_allclose(y_b.numpy(), np.asarray(want_y), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(h_b.numpy(), np.asarray(want_h), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("chunk", [16, 64, 7])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssm_core_matches_reference(chunk, with_h0):
    b, s, d, n = 2, 64, 16, 4
    x, dt, b_in, c_out, a_log = _inputs(chunk, b, s, d, n)
    bc = np.concatenate([b_in, c_out], -1)
    h0 = (np.random.default_rng(1).standard_normal((b, d, n))
          .astype(np.float32) if with_h0 else None)
    y, h_end = ssm.ssm_core({"A_log": torch.from_numpy(a_log)},
                            torch.from_numpy(x), torch.from_numpy(dt),
                            torch.from_numpy(bc),
                            None if h0 is None else torch.from_numpy(h0), n,
                            chunk=chunk)
    want_y, want_h = ref_ssm.ssm_core(
        {"A_log": jnp.asarray(a_log)}, jnp.asarray(x), jnp.asarray(dt),
        jnp.asarray(bc), None if h0 is None else jnp.asarray(h0), n,
        chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(h_end.numpy(), np.asarray(want_h), rtol=1e-4,
                               atol=1e-4)
    if not with_h0:
        oracle = ssm_scan_ref(*_jx((x, dt, b_in, c_out, a_log)))
        np.testing.assert_allclose(y.numpy(), np.asarray(oracle),
                                   rtol=1e-4, atol=1e-4)


def test_chunk_scan_matches_reference_associative_scan():
    rng = np.random.default_rng(2)
    da = rng.uniform(0.2, 1.0, (2, 13, 6, 4)).astype(np.float32)
    dbx = rng.standard_normal((2, 13, 6, 4)).astype(np.float32)
    h0 = rng.standard_normal((2, 6, 4)).astype(np.float32)
    hs, h_end = ssm._chunk_scan(torch.from_numpy(da), torch.from_numpy(dbx),
                                torch.from_numpy(h0))
    want_hs, want_h = ref_ssm._chunk_scan(jnp.asarray(da), jnp.asarray(dbx),
                                          jnp.asarray(h0))
    np.testing.assert_allclose(hs.numpy(), np.asarray(want_hs), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h_end.numpy(), np.asarray(want_h), rtol=1e-5,
                               atol=1e-5)


def _ref_ssm_params(d, n, seed=2):
    return jax.device_get(ref_ssm.init_ssm(jax.random.PRNGKey(seed), d, n))


def test_init_ssm_keys_shapes_and_fixed_leaves_match_reference():
    d, n = 16, 4
    ref = _ref_ssm_params(d, n)
    got = ssm.init_ssm(torch.Generator().manual_seed(0), d, n)
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert tuple(got[key].shape) == ref[key].shape, key
        assert str(got[key].dtype).removeprefix("torch.") == \
            str(ref[key].dtype), key
    # the deterministic leaves are equal; dt stays in softplus^-1 of
    # [1e-3, 1e-1]
    np.testing.assert_array_equal(got["A_log"].numpy(), ref["A_log"])
    np.testing.assert_array_equal(got["D"].numpy(), ref["D"])
    dt = torch.nn.functional.softplus(got["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1001


def test_ssm_forward_and_decode_handoff_match_reference():
    """Full-sequence forward == prefix forward + per-step decode, in the
    port, and both against the reference's."""
    d, n = 16, 4
    ref_p = _ref_ssm_params(d, n)
    p = bridge.from_reference(ref_p, "cpu")
    x = np.random.default_rng(3).standard_normal((1, 12, d)).astype(
        np.float32)
    full, _ = ssm.ssm_forward(p, torch.from_numpy(x), n_state=n, chunk=4)
    want, _ = ref_ssm.ssm_forward(jax.tree_util.tree_map(jnp.asarray, ref_p),
                                  jnp.asarray(x), n_state=n, chunk=4)
    np.testing.assert_allclose(full.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    pre, st = ssm.ssm_forward(p, torch.from_numpy(x[:, :7]), n_state=n,
                              chunk=7)
    outs = [pre]
    for t in range(7, 12):
        y, st = ssm.ssm_decode_step(p, torch.from_numpy(x[:, t:t + 1]), st,
                                    n_state=n)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_causal_conv_matches_reference_with_state():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    state = rng.standard_normal((2, 3, 6)).astype(np.float32)
    for st in (None, state):
        out, new = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                    None if st is None
                                    else torch.from_numpy(st))
        want, want_new = ref_ssm._causal_conv(
            jnp.asarray(x), jnp.asarray(w),
            None if st is None else jnp.asarray(st))
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(new.numpy(), np.asarray(want_new))


def test_init_ssm_state_matches_reference():
    got = ssm.init_ssm_state(3, 8, 4, 2, 4, dtype=torch.float32,
                             device="cpu")
    want = ref_ssm.init_ssm_state(3, 8, 4, 2, 4, dtype=jnp.float32)
    for k in ("h", "conv"):
        assert tuple(got[k].shape) == want[k].shape
        assert not bool(got[k].any())


@pytest.mark.parametrize("s", [1, 9])
def test_ssm_core_on_the_card_is_one_kernel_call(s, monkeypatch):
    """On a CUDA tensor ``ssm_core`` is one call of the kernel's wrapper
    ``ssm_scan`` with B/C as strided views of ``bc`` (no copies) and the
    carried state, returning the final state."""
    n, d = 4, 8
    x, dt, b_in, c_out, a_log = _inputs(s, 2, s, d, n)
    bc = torch.from_numpy(np.concatenate([b_in, c_out], -1))
    h0 = torch.randn(2, d, n, generator=torch.Generator().manual_seed(0))
    calls = []

    def recording(xc, dtc, bi, co, al, h0=None):
        calls.append((bi.data_ptr(), co.data_ptr(), h0))
        return ss.ssm_scan_plain(xc, dtc, bi, co, al, h0)

    monkeypatch.setattr(ss, "ssm_scan", recording)
    monkeypatch.setattr(ssm, "_kernel_route", lambda x: True)
    y, h_end = ssm.ssm_core({"A_log": torch.from_numpy(a_log)},
                            torch.from_numpy(x), torch.from_numpy(dt), bc,
                            h0, n)
    monkeypatch.undo()
    assert len(calls) == 1
    bi_ptr, co_ptr, got_h0 = calls[0]
    assert bi_ptr == bc.data_ptr()
    assert co_ptr == bc.data_ptr() + n * bc.element_size()
    assert got_h0 is h0
    want_y, want_h = ssm.ssm_core({"A_log": torch.from_numpy(a_log)},
                                  torch.from_numpy(x), torch.from_numpy(dt),
                                  bc, h0, n)
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(h_end.numpy(), want_h.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_ssm_scan_wrapper_rejects_bad_shapes():
    x = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError):
        ss.ssm_scan(x, x, torch.zeros(1, 4, 4), torch.zeros(1, 4, 4),
                    torch.zeros(8, 3))
    with pytest.raises(ValueError):
        ss.ssm_scan(x, x, torch.zeros(1, 4, 4), torch.zeros(1, 4, 4),
                    torch.zeros(8, 4), torch.zeros(1, 8, 5))
    assert ss.launches == 0            # the CPU never launches the kernel


# ---------------------------------------------------------------------------
# the kernel's time split, emulated on the CPU
# ---------------------------------------------------------------------------

ROOT = Path(__file__).resolve().parents[1]
# (warps, longest segment, staging block): the emulation holds for any
# split, so the cases take several; the kernel reports the one it was
# built with (``ssm_scan_scratch``) and chip_smoke.py checks it on a card
WIDE_SPLIT = (8, 64, 4)
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def _k5_emulation(x, dt, b_in, c_out, a_log, h0=None, *, split):
    """The arithmetic order of ``csrc/ssm_scan.cu`` in plain torch, for
    these tests only.  x, dt (B,S,D), b_in, c_out (B,S,N) in f32 or bf16
    -> (y in x's dtype, y before its rounding, h_end), all in f32
    arithmetic.  a2 = -exp(a_log) * log2 e once; every decay is
    exp2(dt * a2).  S = 1: one step from h0.  Otherwise ``split`` =
    (warps, seg_max, tb): chunks of ``warps`` segments of ``seg`` steps
    (whole staging blocks of ``tb``, at most ``seg_max``); pass 1 scans each segment from zero (local end state,
    sum of dt); each segment's carry is the chunk's carry-in folded over
    the earlier segments, c = exp2(a2 * sum dt) * c + h_local; pass 2
    reruns the segment from its carry and forms y; the last segment's
    end state carries into the next chunk and is h_end."""
    warps, seg_max, tb = split
    xf, dtf = x.float(), dt.float()
    bf, cf = b_in.float(), c_out.float()
    bsz, s, d = x.shape
    n = b_in.shape[-1]
    a2 = -torch.exp(a_log.float()) * LOG2E                      # (D,N)
    carry = (torch.zeros((bsz, d, n)) if h0 is None else h0.float())
    y = torch.zeros((bsz, s, d))

    def step(h, t):
        dv = dtf[:, t, :, None]
        dx = dv * xf[:, t, :, None]
        return torch.exp2(dv * a2) * h + dx * bf[:, t, None, :]

    if s == 1:
        h = step(carry, 0)
        y[:, 0] = (h * cf[:, 0, None, :]).sum(-1)
        return y.to(x.dtype), y, h
    per = -(-s // warps)
    seg = min(seg_max, -(-per // tb) * tb)
    for k0 in range(0, s, warps * seg):
        spans = [(k0 + w * seg, min(k0 + (w + 1) * seg, s))
                 for w in range(warps)]
        local, sums = [], []
        for t0, t1 in spans:                       # pass 1, from zero
            h = torch.zeros((bsz, d, n))
            sdt = torch.zeros((bsz, d))
            for t in range(t0, t1):
                h = step(h, t)
                sdt = sdt + dtf[:, t]
            local.append(h)
            sums.append(sdt)
        for w, (t0, t1) in enumerate(spans):       # carries, pass 2
            h = carry
            for v in range(w):
                h = torch.exp2(a2 * sums[v][..., None]) * h + local[v]
            for t in range(t0, t1):
                h = step(h, t)
                y[:, t] = (h * cf[:, t, None, :]).sum(-1)
        carry = h
    return y.to(x.dtype), y, carry


def _h0(b, d, n, seed=5):
    return np.random.default_rng(seed).standard_normal((b, d, n)).astype(
        np.float32)


def _ref_with_h0(arrays, h0):
    """y, h_end of the reference's ``ssm_core`` (h0 in, h_end out)."""
    x, dt, b_in, c_out, a_log = arrays
    y, h = ref_ssm.ssm_core({"A_log": jnp.asarray(a_log)}, jnp.asarray(x),
                            jnp.asarray(dt),
                            jnp.asarray(np.concatenate([b_in, c_out], -1)),
                            None if h0 is None else jnp.asarray(h0),
                            b_in.shape[-1], chunk=x.shape[1])
    return np.asarray(y), np.asarray(h)


# (b, s, d, n, split): the kernel tests' shapes at a wide split, and
# small splits that make several chunks; segments that divide S and that
# do not, S shorter than one segment, S = 1
K5_CASES = [(2, 64, 32, 8, WIDE_SPLIT), (1, 128, 64, 16, WIDE_SPLIT),
            (3, 32, 16, 4, WIDE_SPLIT),
            (2, 64, 8, 8, (4, 8, 4)),          # 2 chunks, S = 64
            (1, 70, 8, 16, (4, 8, 4)),         # a ragged last chunk
            (2, 45, 8, 4, (3, 4, 2)),          # segments do not divide S
            (2, 3, 8, 8, (4, 8, 4)),           # shorter than one segment
            (2, 1, 8, 16, WIDE_SPLIT)]         # a decode step


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,d,n,split", K5_CASES)
def test_k5_time_split_matches_the_reference(b, s, d, n, split, with_h0):
    """The kernel's segment order against the JAX reference at the f32
    tolerance: y and h_end (``ssm_core`` with h0), and y against the
    sequential oracle ``ssm_scan_ref`` without it."""
    arrays = _inputs(s * d + n, b, s, d, n)
    h0 = _h0(b, d, n) if with_h0 else None
    y, y_f32, h_end = _k5_emulation(
        *_pt(arrays), None if h0 is None else torch.from_numpy(h0),
        split=split)
    want_y, want_h = _ref_with_h0(arrays, h0)
    np.testing.assert_allclose(y_f32.numpy(), want_y, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h_end.numpy(), want_h, rtol=1e-4, atol=1e-4)
    if h0 is None:
        oracle = np.asarray(ssm_scan_ref(*_jx(arrays)))
        np.testing.assert_allclose(y.numpy(), oracle, rtol=1e-4, atol=1e-4)
    # and the plain twin, the kernel's check on the card
    y_p, h_p = ss.ssm_scan_plain(
        *_pt(arrays), None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(y.numpy(), y_p.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(h_end.numpy(), h_p.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("n", [4, 8, 16])
def test_k5_time_split_bf16_rounds_y_once(n):
    """bf16 inputs: the arithmetic is f32 from the bf16 values (within
    1e-4 of the reference on the same values) and y is rounded once,
    within the scan's bf16 tolerance (rtol 1e-2, atol 1e-3) of the
    reference's bf16 output."""
    arrays = list(_inputs(n, 2, 70, 16, n))
    for i in range(4):
        arrays[i] = arrays[i].astype(ml_dtypes.bfloat16)
    y, y_f32, _ = _k5_emulation(*_pt(arrays), split=(4, 8, 4))
    assert y.dtype == torch.bfloat16
    as_f32 = [a.astype(np.float32) for a in arrays[:4]] + [arrays[4]]
    np.testing.assert_allclose(y_f32.numpy(),
                               np.asarray(ssm_scan_ref(*_jx(as_f32))),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(y.float().numpy(),
                                  y_f32.to(torch.bfloat16).float().numpy())
    np.testing.assert_allclose(
        y.float().numpy(),
        np.asarray(ssm_scan_ref(*_jx(arrays)), np.float32),
        rtol=1e-2, atol=1e-3)


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _chunks(s, split):
    """(chunks, steps a chunk) of S steps under ``split``, as the
    emulation splits them."""
    warps, seg_max, tb = split
    seg = min(seg_max, -(-(-(-s // warps)) // tb) * tb)
    return -(-s // (warps * seg)), warps * seg


def test_k5_cases_reach_every_edge_of_the_split():
    """The cases above reach more than one chunk, a ragged last chunk,
    segments with no steps and a decode step."""
    shapes = [(s, split) for _, s, _, _, split in K5_CASES if s > 1]
    assert any(_chunks(s, sp)[0] > 1 for s, sp in shapes)
    assert any(s % _chunks(s, sp)[1] for s, sp in shapes)
    assert any(s < _chunks(s, sp)[1] // sp[0] * (sp[0] - 1)
               for s, sp in shapes)
    assert any(s == 1 for _, s, *_ in K5_CASES)


def test_chip_smoke_counts_exps_from_the_split_the_kernel_reports(
        monkeypatch):
    """chip_smoke.py takes K5's time split from the built library
    (``ssm_scan_scratch`` which = 2, 3, 4: segment length, segments a
    chunk, chunks) and counts the design's exps from it: two per (t, d,
    n), and N per earlier segment of each chunk; one per state for a
    decode step."""
    smoke = _chip_smoke()
    asked = []

    class FakeLib:
        @staticmethod
        def ssm_scan_scratch(b, s, d, n, which):
            asked.append((b, s, d, n, which))
            return {2: 64, 3: 8, 4: 8}[which]

    monkeypatch.setattr(ss, "_lib", lambda: FakeLib)
    b, d, n = 2, 3200, 16
    split = smoke.ssm_split(b, 4096, d, n)
    assert split == {"seg": 64, "warps": 8, "chunks": 8}
    assert [a[-1] for a in asked] == [2, 3, 4]
    assert all(a[:4] == (b, 4096, d, n) for a in asked)
    assert smoke.ssm_design_exps(b, 1, d, n, None) == b * d * n
    assert smoke.ssm_design_exps(b, 4096, d, n, split) == \
        2 * b * 4096 * d * n + b * d * n * 8 * 8 * 7 // 2
    # a split of one segment a chunk folds no carries inside a chunk
    assert smoke.ssm_design_exps(
        b, 4096, d, n, {"seg": 512, "warps": 1, "chunks": 8}) == \
        2 * b * 4096 * d * n


def _bwd_split(s, split=WIDE_SPLIT, blk=8):
    """Segment lengths of every warp of every chunk, and the lengths of
    their checkpoint blocks, under the forward kernel's split of S
    steps (S = 1: one step in one segment), as K5's backward takes it."""
    warps = split[0]
    chunks, chunk = _chunks(s, split) if s > 1 else (1, warps)
    seg = chunk // warps
    lens = [max(0, min(t0 + seg, s) - t0)
            for t0 in range(0, chunks * chunk, seg)]
    return chunks, lens, [min(blk, ln - j) for ln in lens
                          for j in range(0, ln, blk)]


def test_k5_backward_cases_reach_every_edge_of_the_split():
    """chip_smoke.py's K5 backward cases at the edges of the split (the
    forward's, ``WIDE_SPLIT`` as the kernel is built; 8-step checkpoint
    blocks walked back as two register halves of 4) reach one step,
    more than one chunk, a ragged last chunk, empty segments, a block
    whose later half is short and one with no later half, D off the
    32-channel group, N 4, 8 and 16, h0 and dh_end each present and
    absent."""
    smoke = _chip_smoke()
    cases = [case for _, case, _, _ in smoke.SSM_BWD_SPLIT_CASES]
    splits = [_bwd_split(s) for _, s, _, _ in cases]
    assert any(s == 1 for _, s, _, _ in cases)
    assert any(chunks > 1 for chunks, _, _ in splits)
    assert any(s > 1 and s % _chunks(s, WIDE_SPLIT)[1]
               for _, s, _, _ in cases)
    assert any(0 in lens for _, lens, _ in splits)
    assert any(any(4 < bl < 8 for bl in blocks) for _, _, blocks in splits)
    assert any(any(bl <= 4 for bl in blocks) for _, _, blocks in splits)
    assert any(d % 32 for _, _, d, _ in cases)
    assert {n for *_, n in cases} == {4, 8, 16}
    flags = [(h0, dh_end) for _, _, h0, dh_end in smoke.SSM_BWD_SPLIT_CASES]
    assert {h for h, _ in flags} == {True, False}
    assert {e for _, e in flags} == {True, False}


def test_chip_smoke_counts_k5_backward_exps_from_its_split(monkeypatch):
    """chip_smoke.py takes K5's backward split from the built libraries
    (the forward's segment, warps and chunks, the backward's checkpoint
    block and half) and counts the design's exps from it: per segment
    of L steps 3L (the two passes from zero, the walk back), the
    checkpoint walk up to the last block, each block replayed (plus the
    half skipped into for a later half), and N a fold."""
    smoke = _chip_smoke()

    class FakeBwd:
        @staticmethod
        def ssm_scan_bwd_sizes(b, s, d, n, chunks, which):
            return {4: 8, 5: 4}[which]

    monkeypatch.setattr(ss, "time_split", lambda b, s, d, n: (64, 8, 4))
    monkeypatch.setattr(ss, "_bwd_lib", lambda: FakeBwd)
    b, s, d, n = 1, 2048, 3200, 16
    split = smoke.ssm_bwd_split(b, s, d, n)
    assert split == {"seg": 64, "warps": 8, "chunks": 4, "block": 8,
                     "half": 4}
    # a 64-step segment: 3 x 64, the walk to its 8th block 56, 8 blocks
    # of 8 replayed as 12 each; 4 chunks of 8 segments, 57 folds each
    per_segment = 3 * 64 + 56 + 8 * 12
    assert smoke.ssm_bwd_design_exps(b, s, d, n, split) == \
        b * d * n * 4 * (8 * per_segment + 57)
    # S = 37 at 8-step segments: 4 full segments and one of 5 steps
    short = {"seg": 8, "warps": 8, "chunks": 1, "block": 8, "half": 4}
    assert smoke.ssm_bwd_design_exps(1, 37, 1, 1, short) == \
        4 * (3 * 8 + 0 + 12) + (3 * 5 + 0 + 5 + 4) + 57
