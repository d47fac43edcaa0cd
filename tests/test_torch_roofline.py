"""The port's ``roofline/``: ``analysis.py`` is the JAX package's HLO
parser and roofline terms, copied (equal outputs on HLO text of
jax-lowered programs); ``cost.py`` holds the kernels' bounds (they
reproduce the figures ``PERF.md`` prints) and ``step_cost``, a whole
step's dot FLOPs counted from the config, held against

* the reference's ``analyze_hlo`` of its compiled step, within 1 %,
  once the count is put on the reference's terms: attention's products
  over the pairs the reference's branch computes (the naive einsum's
  whole S x T, whole chunks for the chunked and banded ones, where the
  port's count is K4's visible pairs); hymba's scan output ``einsum(hs,
  C)``, a product of the reference's jnp scan where the port's card
  route is K5 (its other backward product is an outer product, which
  XLA does as a multiply); the backward products autograd skips and a
  scanned backward runs (``skipped_backward_flops``); and at one loss
  chunk, one logits product fewer (XLA drops the single-trip loop and
  merges the forward logits with their recomputation);
* the port's own step run on ``meta`` tensors under a dispatch mode
  that counts the products (mm, addmm, bmm, baddbmm, convolution),
  exactly, on the plain branches the CPU takes (the same attention
  pairs, and hymba's scan-output product).
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.config import get_arch as ref_get_arch
from repro.config.base import InputShape as RefShape
from repro.config.base import TrainConfig as RefTrainConfig
from repro.launch import steps as ref_steps
from repro.roofline import analysis as ref_an
from repro_torch.config import get_arch
from repro_torch.config.base import InputShape, TrainConfig
from repro_torch.launch import steps
from repro_torch.roofline import analysis as an
from repro_torch.roofline import cost

ROOT = Path(__file__).resolve().parents[1]
aten = torch.ops.aten

# one reduced config of each family of test_torch_lm_train.py's ARCHS
# (dense, hybrid, MoE, xLSTM), and the audio encoder
FAMILY_ARCHS = ["llama3.2-1b", "hymba-1.5b", "mixtral-8x7b", "xlstm-350m",
                "hubert-xlarge"]
# (kind, seq) a case: a train shape with the chunked attention branch
# and a prefill shape on the naive branch (S * T <= 256 * 256).  xLSTM
# runs two mLSTM chunks against the reference (at one chunk XLA drops
# the loop and folds the products of the zero initial state away), and
# its sLSTM token loop is cut to 128 tokens on meta
SHAPES = {"train": 512, "prefill": 256}
REF_SEQ = {("xlstm-350m", "prefill"): 512}
META_SEQ = {("xlstm-350m", "train"): 128}
BATCH = 2


# ---------------------------------------------------------------------------
# analysis.py: a copy of the reference's
# ---------------------------------------------------------------------------

def _scanned_matmul_hlo():
    def f(w, x):
        def body(c, _):
            return c @ w, None
        out, _ = jax.lax.scan(body, x, None, length=5)
        return out.sum()
    return jax.jit(f).lower(
        jax.ShapeDtypeStruct((32, 32), jnp.float32),
        jax.ShapeDtypeStruct((8, 32), jnp.float32)).compile().as_text()


_HLO = {}


def _ref_step_hlo(arch, kind, seq, tcfg=None):
    key = (arch, kind, seq, tcfg)
    if key not in _HLO:
        cfg = ref_get_arch(arch).reduced()
        tcfg = tcfg or RefTrainConfig()
        shape = RefShape("case", seq, BATCH, kind)
        params = ref_steps.abstract_params(cfg, tcfg)
        batch = ref_steps.input_specs(cfg, shape, tcfg)
        if kind == "train":
            step, _ = ref_steps.make_train_step(cfg, tcfg)
            lowered = jax.jit(step).lower(
                params, ref_steps.abstract_opt_state(cfg, tcfg), batch)
        else:
            lowered = jax.jit(ref_steps.make_prefill_step(cfg, tcfg)).lower(
                params, batch)
        _HLO[key] = lowered.compile().as_text()
    return _HLO[key]


@pytest.mark.parametrize("which", ["scanned_matmul", "train_step"])
def test_analyze_hlo_and_helpers_equal_the_reference(which):
    hlo = (_scanned_matmul_hlo() if which == "scanned_matmul"
           else _ref_step_hlo("llama3.2-1b", "train", 512))
    got, want = an.analyze_hlo(hlo), ref_an.analyze_hlo(hlo)
    assert got == want
    assert got["dot_flops"] > 0
    if which == "scanned_matmul":
        assert got["dot_flops"] == pytest.approx(5 * 2 * 8 * 32 * 32,
                                                 rel=0.05)
    comps = an._split_computations(hlo)
    assert comps == ref_an._split_computations(hlo)
    for name, lines in comps.items():
        assert an._instr_defs(lines) == ref_an._instr_defs(lines)
        assert an._trip_count(lines) == ref_an._trip_count(lines)
        defs = an._instr_defs(lines)
        for ln in lines:
            assert an._dot_flops(ln, defs) == ref_an._dot_flops(ln, defs)
            assert an._conv_flops(ln, defs) == ref_an._conv_flops(ln, defs)
            assert an._operand_names(ln) == ref_an._operand_names(ln)
            assert an._shape_bytes(ln) == ref_an._shape_bytes(ln)
            assert an._shape_elems(ln) == ref_an._shape_elems(ln)
            assert an._shape_dims(ln) == ref_an._shape_dims(ln)


def test_the_copied_tables_are_the_reference_tables():
    assert an._DTYPE_BYTES == ref_an._DTYPE_BYTES
    assert an._COLLECTIVES == ref_an._COLLECTIVES
    assert an._COLL_WEIGHT == ref_an._COLL_WEIGHT
    assert an._SHAPE_RE.pattern == ref_an._SHAPE_RE.pattern


def test_hwspec_tpu_v5e_and_roofline_terms_equal_the_reference():
    assert an.TPU_V5E.__dict__ == ref_an.TPU_V5E.__dict__
    assert [f.name for f in an.HWSpec.__dataclass_fields__.values()] == \
        [f.name for f in ref_an.HWSpec.__dataclass_fields__.values()]
    for fl, hb, cb, chips in ((197e12, 0, 0, 1), (0, 819e9, 1e12, 1),
                              (3e15, 2e12, 5e10, 256), (1.0, 2.0, 3.0, 4),
                              (0, 0, 0, 1)):
        kw = dict(hlo_flops=fl, hbm_bytes=hb, collective_bytes=cb,
                  chips=chips)
        assert an.roofline_terms(hw=an.TPU_V5E, **kw) == \
            ref_an.roofline_terms(**kw)


def test_h100_is_the_default_and_its_data_sheet_peaks():
    h = an.H100_SXM
    assert (h.name, h.peak_flops, h.hbm_bw, h.ici_bw) == \
        ("h100-sxm5-80gb", 989e12, 3.35e12, 450e9)
    t = an.roofline_terms(hlo_flops=989e12, hbm_bytes=0,
                          collective_bytes=0, chips=1)
    assert t["dominant"] == "compute_s" and t["compute_s"] == 1.0
    assert an.roofline_terms(hlo_flops=0, hbm_bytes=3.35e12 * 4,
                             collective_bytes=0, chips=4)["memory_s"] == 1.0
    assert cost.HBM_BYTES_PER_S == h.hbm_bw
    assert cost.BF16_TENSOR_FLOPS_PER_S == h.peak_flops


# ---------------------------------------------------------------------------
# cost.py (a): the kernels' bounds, as PERF.md prints them
# ---------------------------------------------------------------------------

def _printed(x, text):
    """``x`` rounded to the decimals of ``text`` is ``text``."""
    decimals = len(text.split(".")[1])
    assert f"{x:.{decimals}f}" == text, (x, text)


P = 1_630_090


@pytest.mark.parametrize("case", [
    ("K1 N=32", lambda: cost.fedagg_bound_ms(torch.ones(32), P)[0],
     "0.06423"),
    ("K1 N=5", lambda: cost.fedagg_bound_ms(torch.ones(5), P)[0], "0.01168"),
    ("K2 K=32", lambda: cost.fold_bound_ms(torch.ones(33), P)[0], "0.06618"),
    ("K2 K=8, 6 live", lambda: cost.fold_bound_ms(
        torch.tensor([1.0] * 7 + [0.0, 0.0]), P)[0], "0.01557"),
    ("K3 R=8", lambda: cost.partial_bound_ms(torch.ones(8), P)[0],
     "0.01752"),
    ("K3 R=2", lambda: cost.partial_bound_ms(torch.ones(2), P)[0],
     "0.00584"),
    ("K4 hymba 4096 window", lambda: cost.flash_bound_ms(
        (2, 4096, 25, 64), (2, 4096, 5, 64), 2, True, 1024, 0)[0], "0.0475"),
    ("K4 hymba 1024 causal", lambda: cost.flash_bound_ms(
        (2, 1024, 25, 64), (2, 1024, 5, 64), 2, True, 0, 0)[0], "0.00679"),
    ("K4 llama causal", lambda: cost.flash_bound_ms(
        (2, 4096, 32, 64), (2, 4096, 8, 64), 2, True, 0, 0)[0], "0.1390"),
    ("K4 mixtral D=128", lambda: cost.flash_bound_ms(
        (2, 4096, 32, 128), (2, 4096, 8, 128), 2, True, 4096, 0)[0],
     "0.2780"),
    ("K4 nemotron D=192", lambda: cost.flash_bound_ms(
        (1, 4096, 96, 192), (1, 4096, 8, 192), 2, True, 0, 0)[0], "0.6255"),
    ("K4 hubert D=80", lambda: cost.flash_bound_ms(
        (8, 1024, 16, 80), (8, 1024, 16, 80), 2, False, 0, 0)[0], "0.0434"),
    ("K5 prefill", lambda: cost.ssm_bound_ms(2, 4096, 3200, 16, 2,
                                             False)[0], "0.1003"),
    ("K5 decode", lambda: cost.ssm_bound_ms(4, 1, 3200, 16, 2, True)[0],
     "0.00057"),
    ("K4 f32 fwd hymba", lambda: cost.flash_bwd_bound_ms(
        (1, 2048, 25, 64), (1, 2048, 5, 64), *cost.FA_FWD_WORK,
        window=1024)["ms"], "0.0611"),
    ("K4 f32 fwd llama CUDA cores", lambda: cost.flash_bwd_bound_ms(
        (2, 2048, 32, 64), (2, 2048, 8, 64), *cost.FA_FWD_WORK)[
            "cuda_core_ms"], "0.5131"),
    ("K4 f32 bwd pair hymba", lambda: cost.flash_bwd_bound_ms(
        (1, 2048, 25, 64), (1, 2048, 5, 64), *cost.FA_BWD_WORK[2][1:],
        window=1024)["ms"], "0.1527"),
    ("K4 f32 bwd dq llama", lambda: cost.flash_bwd_bound_ms(
        (2, 2048, 32, 64), (2, 2048, 8, 64), *cost.FA_BWD_WORK[0][1:])[
            "ms"], "0.3127"),
    ("K4 f32 bwd dkdv llama", lambda: cost.flash_bwd_bound_ms(
        (2, 2048, 32, 64), (2, 2048, 8, 64), *cost.FA_BWD_WORK[1][1:])[
            "ms"], "0.4169"),
    ("K4 bf16 fwd lse llama", lambda: cost.flash_bwd_bf16_bound_ms(
        (2, 2048, 32, 64), (2, 2048, 8, 64), *cost.FA_FWD_BF16_WORK)["ms"],
     "0.0348"),
    ("K4 bf16 bwd pair hymba", lambda: cost.flash_bwd_bf16_bound_ms(
        (1, 2048, 25, 64), (1, 2048, 5, 64), *cost.FA_BWD_BF16_WORK[2][1:],
        window=1024)["ms"], "0.0255"),
    ("K5 bwd f32 bytes", lambda: cost.ssm_bwd_bound_ms(1, 2048, 3200, 16,
                                                        4)[0], "0.0394"),
    ("K5 bwd bf16 exps", lambda: cost.ssm_bwd_bound_ms(1, 2048, 3200, 16,
                                                        2)[1], "0.0251"),
], ids=lambda c: c[0])
def test_bounds_reproduce_perf_md(case):
    _, fn, text = case
    _printed(fn(), text)


# the capped training kernels at llama3.2-1b's layer: the bf16 forward
# with lse and dq are bound by their two SFU operations a pair, the
# rest by their dots as without a cap
SOFTCAP_PRINTED = {("bf16", "fwd_lse"): "0.0642", ("bf16", "dq"): "0.0642",
                   ("bf16", "dkdv"): "0.0695", ("bf16", "pair"): "0.0869",
                   ("f32", "fwd_lse"): "0.2085", ("f32", "dq"): "0.3127",
                   ("f32", "dkdv"): "0.4169", ("f32", "pair"): "0.5212"}


@pytest.mark.parametrize("dtype,kind", sorted(SOFTCAP_PRINTED))
def test_softcap_training_bounds_count_two_sfu_operations_a_pair(dtype,
                                                                 kind):
    """K4's training kernels with a logit softcap: the dots and bytes of
    the kernel without a cap, and two special-function operations a
    visible pair (the exp, and the tanh's), against the SFU's rate; at
    llama's training layer (2, 2048, 32, 64), kv 8, causal, as PERF.md
    prints them."""
    qs, ks = (2, 2048, 32, 64), (2, 2048, 8, 64)
    bf16 = dtype == "bf16"
    fn = cost.flash_bwd_bf16_bound_ms if bf16 else cost.flash_bwd_bound_ms
    work = {w[0]: w[1:] for w in (
        (cost.FA_BWD_BF16_WORK + (("fwd_lse",) + cost.FA_FWD_BF16_WORK,))
        if bf16 else (cost.FA_BWD_WORK + (("fwd_lse",)
                                          + cost.FA_FWD_WORK,)))}[kind]
    plain = fn(qs, ks, *work)
    capped = fn(qs, ks, *work, sfu_per_pair=cost.SOFTCAP_SFU_PER_PAIR)
    pairs = 2 * 32 * cost.visible_pairs(2048, 2048, True, 0, 0)
    assert cost.SOFTCAP_SFU_PER_PAIR == 2
    assert plain["exps"] == pairs and capped["exps"] == 2 * pairs
    assert capped["flops"] == plain["flops"] == 2 * 64 * work[0] * pairs
    sfu_ms = 2 * pairs / cost.SFU_EXP_PER_S * 1e3
    if bf16:
        assert capped["bytes"] == plain["bytes"]
        ops = max(plain["flops"] / cost.BF16_TENSOR_FLOPS_PER_S * 1e3,
                  sfu_ms)
        assert capped["ms"] == pytest.approx(
            max(ops, capped["bytes"] / cost.HBM_BYTES_PER_S * 1e3))
    else:
        assert capped["bytes_ms"] == plain["bytes_ms"]
        assert capped["ms"] == pytest.approx(max(
            min(max(plain["flops"] / cost.F32_FLOPS_PER_S * 1e3, sfu_ms),
                max(plain["tf32_flops"] / cost.TF32_TENSOR_FLOPS_PER_S
                    * 1e3, sfu_ms)), capped["bytes_ms"]))
    assert capped["ms"] >= plain["ms"]
    _printed(capped["ms"], SOFTCAP_PRINTED[dtype, kind])


def test_chip_smoke_prints_the_bounds_of_cost_py():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_roofline", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for name in ("fedagg_bound_ms", "fold_bound_ms", "partial_bound_ms",
                 "flash_bound_ms", "flash_bwd_bound_ms",
                 "flash_bwd_bf16_bound_ms", "ssm_bound_ms",
                 "ssm_bwd_bound_ms", "FA_BWD_WORK", "FA_FWD_WORK",
                 "FA_BWD_BF16_WORK", "FA_FWD_BF16_WORK", "SFU_EXP_PER_S",
                 "BF16_TENSOR_FLOPS_PER_S", "HBM_BYTES_PER_S",
                 "visible_pairs"):
        assert getattr(smoke, name) is getattr(cost, name), name
    src = (ROOT / "chip_smoke.py").read_text()
    for name in ("def visible_pairs", "def flash_bound_ms",
                 "def fedagg_bound_ms", "HBM_BYTES_PER_S = "):
        assert name not in src


@pytest.mark.parametrize("s,t,causal,window,q_offset", [
    (1, 1, True, 0, 0), (7, 7, False, 0, 0), (64, 64, True, 16, 0),
    (100, 300, True, 0, 200), (33, 33, True, 1, 0), (50, 80, False, 10, 5)])
def test_visible_pairs_counts_the_mask(s, t, causal, window, q_offset):
    q = torch.arange(q_offset, q_offset + s)[:, None]
    k = torch.arange(t)[None, :]
    m = torch.ones((s, t), dtype=torch.bool)
    if causal:
        m &= k <= q
    if window > 0:
        m &= k > q - window
    assert cost.visible_pairs(s, t, causal, window, q_offset) == \
        int(m.sum())


# ---------------------------------------------------------------------------
# cost.py (b): step_cost against the reference's HLO and the port's step
# ---------------------------------------------------------------------------

def _branch_pairs(s, t, causal, window, chunk_q, chunk_kv):
    """(q, k) pairs a (batch row, head) computes on the plain branches
    (the reference's, and the port's on the CPU): the naive einsum's
    whole S x T; whole chunks for the chunked branch (every KV chunk of
    every Q chunk); the band's ``nb`` KV chunks of every Q chunk for
    the banded one."""
    if s * t <= 256 * 256 or s % min(chunk_q, s) or t % min(chunk_kv, t):
        return s * t
    cq, ckv = min(chunk_q, s), min(chunk_kv, t)
    if window and window < t:
        nb = min((window - 1 + cq + ckv - 1) // ckv + 1, t // ckv)
        return s * nb * ckv
    return s * t


def _scan_output_flops(cfg, b, s):
    """hymba's ``einsum("bqdn,bqn->bqd", hs, C)`` over all layers: the
    plain scan's product that K5 replaces on the card."""
    if cfg.family != "hybrid":
        return 0.0
    return 2.0 * b * s * cfg.ssm_expand * cfg.d_model * cfg.ssm_state \
        * cfg.num_layers


def _loss_chunks(cfg, s):
    s = s if cfg.is_encoder_only else s - 1
    c = min(512, s)
    return 1 if s % c else s // c


def _seq(arch, kind, meta=False):
    return (META_SEQ if meta else REF_SEQ).get((arch, kind), SHAPES[kind])


class _CountProducts(TorchDispatchMode):
    """Dot flops of the products dispatched under it (meta tensors)."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (aten.mm.default, aten.addmm.default):
            a, b = args[-2:]
            self.flops += 2 * a.shape[0] * a.shape[1] * b.shape[1]
        elif func in (aten.bmm.default, aten.baddbmm.default):
            a, b = args[-2:]
            self.flops += 2 * a.shape[0] * a.shape[1] * a.shape[2] \
                * b.shape[2]
        elif func is aten.convolution.default:
            x, w = args[0], args[1]
            self.flops += 2 * out.numel() * w[0].numel()
        return out


def _meta_step_flops(cfg, shape, tcfg):
    params = steps.abstract_params(cfg, tcfg)
    batch = {k: torch.zeros(x.shape, dtype=x.dtype, device="meta")
             for k, x in steps.input_specs(cfg, shape, tcfg).items()}
    with _CountProducts() as c:
        if shape.kind == "train":
            step, _ = steps.make_train_step(cfg, tcfg)
            step(params, steps.abstract_opt_state(cfg, tcfg), batch)
        else:
            steps.make_prefill_step(cfg, tcfg)(params, batch)
    return c.flops


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_step_cost_is_the_reference_hlo_within_1pc(arch, kind):
    seq = _seq(arch, kind)
    cfg = get_arch(arch).reduced()
    tcfg = TrainConfig()
    got = cost.step_cost(cfg, InputShape("case", seq, BATCH, kind), tcfg,
                         pairs=_branch_pairs)
    want = ref_an.analyze_hlo(_ref_step_hlo(arch, kind, seq))["dot_flops"]
    on_ref_terms = got["dot_flops"]
    scan_out = _scan_output_flops(cfg, BATCH, seq)
    if kind == "train":
        on_ref_terms += (2 + tcfg.remat) * scan_out
        on_ref_terms += got["skipped_backward_flops"]
        if _loss_chunks(cfg, seq) == 1:
            on_ref_terms -= got["terms"]["head"]
    else:
        on_ref_terms += scan_out
    assert on_ref_terms == pytest.approx(want, rel=0.01)


def test_step_cost_at_two_loss_chunks_is_the_reference_hlo():
    """At two loss chunks (S - 1 = 1024) no loss term converts: the
    reference's HLO counts the port's four logits products."""
    cfg = get_arch("llama3.2-1b").reduced()
    got = cost.step_cost(cfg, InputShape("case", 1025, BATCH, "train"),
                         TrainConfig(), pairs=_branch_pairs)
    want = ref_an.analyze_hlo(
        _ref_step_hlo("llama3.2-1b", "train", 1025))["dot_flops"]
    assert _loss_chunks(cfg, 1025) == 2
    assert got["dot_flops"] == pytest.approx(want, rel=1e-3)


@pytest.mark.parametrize("kind,remat,policy", [
    ("train", True, "full"), ("train", True, "dots"), ("train", False, "full"),
    ("prefill", True, "full")])        # a prefill step does not remat
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_step_cost_is_the_port_step_on_meta(arch, kind, remat, policy):
    seq = _seq(arch, kind, meta=True)
    cfg = get_arch(arch).reduced()
    tcfg = TrainConfig(dtype="float32", remat=remat, remat_policy=policy)
    shape = InputShape("case", seq, BATCH, kind)
    got = cost.step_cost(cfg, shape, tcfg, pairs=_branch_pairs)
    on_cpu = got["dot_flops"] + (
        (3 + remat) if kind == "train" else 1) * _scan_output_flops(
            cfg, BATCH, seq)
    assert on_cpu == _meta_step_flops(cfg, shape, tcfg)


def test_step_cost_on_the_card_counts_k4_visible_pairs():
    """The card's count: K4's visible pairs in place of the square."""
    cfg = get_arch("hymba-1.5b")
    shape = InputShape("case", 4096, 2, "prefill")
    got = cost.step_cost(cfg, shape)
    pairs = cost.visible_pairs(4096, 4096, True, cfg.sliding_window, 0)
    assert got["kernel"]["k4_pairs"] == 2 * cfg.n_heads * cfg.num_layers \
        * pairs
    assert got["attention_flops"] == 4 * cfg.head_dim * \
        got["kernel"]["k4_pairs"]
    assert got["kernel"]["k4_calls"] == got["kernel"]["k5_calls"] == \
        cfg.num_layers
    square = cost.step_cost(cfg, shape, pairs=lambda s, t, *a: s * t)
    assert square["attention_flops"] > got["attention_flops"]


def test_step_cost_train_counts_backward_recompute_and_optimizer():
    cfg = dataclasses_replace(get_arch("llama3.2-1b"), num_layers=2)
    shape = InputShape("case", 2048, 2, "train")
    full = cost.step_cost(cfg, shape, TrainConfig(dtype="float32"))
    off = cost.step_cost(cfg, shape, TrainConfig(dtype="float32",
                                                 remat=False))
    fwd = full["forward_flops"]
    head = full["terms"]["head"]
    last = full["terms"]["mlp.w_down"]
    assert off["dot_flops"] == 3 * fwd + head
    assert full["dot_flops"] == off["dot_flops"] + fwd - head - last
    n = full["params"]
    assert n == sum(x.numel() for x in
                    __import__("repro_torch.tree", fromlist=["x"])
                    .tree_leaves(steps.abstract_params(cfg)))
    assert cost.optimizer_bytes_per_param(TrainConfig(dtype="float32")) \
        == 192
    assert full["optimizer_bytes"] == 192 * n
    assert full["hbm_bytes"] > full["optimizer_bytes"]


def dataclasses_replace(cfg, **kw):
    import dataclasses
    return dataclasses.replace(cfg, **kw)


def test_step_share_reads_mfu_and_bound_over_step():
    cfg = dataclasses_replace(get_arch("llama3.2-1b"), num_layers=16)
    shape = InputShape("llama-train", 2048, 2, "train")
    tcfg = TrainConfig()
    r = cost.step_share(cfg, shape, tcfg, 0.5)
    mf = steps.model_flops(cfg, shape)
    assert r["model_flops"] == mf
    assert r["mfu"] == mf / (0.5 * 989e12)
    assert r["bound_over_step"] == r["bound_s"] / 0.5
    assert r["bound_s"] == max(r["compute_s"], r["memory_s"])
    assert r["compute_s"] == r["dot_flops"] / 989e12
    assert r["memory_s"] == r["hbm_bytes"] / 3.35e12
    json.dumps(r)
