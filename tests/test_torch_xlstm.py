"""The port's xLSTM family (``models/xlstm.py``, the ``ssm`` branches of
``models/transformer.py``, config ``xlstm-350m``) against the JAX
package's: the mLSTM's chunkwise core (chunk boundaries crossed, and the
one-chunk fallback when the chunk does not divide S), the sLSTM's time
loop and its state handoff, both blocks with and without state, the
model's parameter tree, forward, ``lm_loss`` and its gradients, and
decode, with reduced ``xlstm-350m`` parameters made by the reference's
``init_model`` and carried across with ``bridge.from_reference``, the
same numpy inputs on both sides.

Tolerances: module outputs within 1e-5 * max(1, max|want|) (f32 sums
in another order; the exps of the gates); the whole model 1e-4;
gradients rtol 1e-4, atol 1e-4 * max(1, max|want|) (the forward's
tolerance carried through the backward; ``torch.cummax`` and
``jax.lax.associative_scan(maximum)`` differ in their gradients only on
exact ties, which random inputs do not make); decode 2e-4, the
reference's own tolerance for this family
(``tests/test_decode_consistency.py``).  bf16 blocks: 2e-2 relative (the
reference's roundings, f32 sums in another order before each).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.config import get_arch as ref_get_arch
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_decode_state as ref_init_decode_state
from repro.models import init_model as ref_init_model
from repro.models import lm_loss as ref_lm_loss
from repro.models import xlstm as ref_xlstm
from repro_torch import bridge
from repro_torch.config import get_arch
from repro_torch.launch import steps
from repro_torch.models import (decode_step, forward, init_decode_state,
                                init_model, lm_loss, xlstm)
from repro_torch.tree import tree_flatten, tree_leaves

torch.set_num_threads(1)

ARCH = "xlstm-350m"
_PARAMS = {}


def _params():
    """(reference params as jax arrays, the port's bridged copy)."""
    if ARCH not in _PARAMS:
        cfg = ref_get_arch(ARCH).reduced()
        ref = ref_init_model(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
        _PARAMS[ARCH] = (ref, bridge.from_reference(jax.device_get(ref),
                                                    "cpu"))
    return _PARAMS[ARCH]


def _module_close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _tokens(b, s, seed=0):
    vocab = get_arch(ARCH).reduced().vocab_size
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _core_inputs(rng, b, h, s, dh):
    q, k, v = (rng.standard_normal((b, h, s, dh)).astype(np.float32)
               for _ in range(3))
    logi = rng.standard_normal((b, h, s)).astype(np.float32)
    logf = np.asarray(jax.nn.log_sigmoid(
        rng.standard_normal((b, h, s)).astype(np.float32) + 2.0))
    return q, k, v, logi, logf


def _to_torch(xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(32, 8), (64, 16), (48, 48), (40, 8),
                                     (40, 16)])
@pytest.mark.parametrize("with_carry", [False, True])
def test_mlstm_core_matches_reference(s, chunk, with_carry):
    """Outputs and the carry out; (40, 16) is the one-chunk fallback."""
    rng = np.random.default_rng(s * 100 + chunk)
    b, h, dh = 2, 3, 8
    ins = _core_inputs(rng, b, h, s, dh)
    carry = None
    if with_carry:
        carry = (rng.standard_normal((b, h, dh, dh)).astype(np.float32),
                 rng.standard_normal((b, h, dh)).astype(np.float32),
                 rng.standard_normal((b, h)).astype(np.float32))
    want, want_car = ref_xlstm.mlstm_core(
        *map(jnp.asarray, ins),
        None if carry is None else tuple(map(jnp.asarray, carry)), chunk)
    got, got_car = xlstm.mlstm_core(
        *_to_torch(ins), None if carry is None else _to_torch(carry), chunk)
    assert tuple(got.shape) == want.shape
    _module_close(got, want)
    assert len(got_car) == len(want_car) == 3
    for a, w in zip(got_car, want_car):
        _module_close(a, w)


def test_cummax_is_the_reference_running_maximum():
    x = np.random.default_rng(1).standard_normal((2, 3, 17)).astype(
        np.float32)
    got = xlstm._cummax(torch.from_numpy(x), -1)
    want = ref_xlstm._cummax(jnp.asarray(x), axis=-1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _slstm_params(d=32, h=4, seed=1):
    ref_p = jax.device_get(ref_xlstm.init_slstm(jax.random.PRNGKey(seed),
                                                d, h))
    return ref_p, bridge.from_reference(ref_p, "cpu")


def test_slstm_scan_and_its_state_handoff_match_reference():
    """The whole sequence at once, and cut at t = 9 with the state handed
    over: each equal to the reference's, and the two halves to the
    whole."""
    d, h = 32, 4
    ref_p, p = _slstm_params(d, h)
    x = np.random.default_rng(2).standard_normal((2, 20, d)).astype(
        np.float32)
    want, want_st = ref_xlstm.slstm_scan(ref_p, jnp.asarray(x), h)
    got, got_st = xlstm.slstm_scan(p, torch.from_numpy(x), h)
    _module_close(got, want)
    for key in ("c", "n", "m", "h"):
        _module_close(got_st[key], want_st[key])
    a, st = xlstm.slstm_scan(p, torch.from_numpy(x[:, :9]), h)
    b, _ = xlstm.slstm_scan(p, torch.from_numpy(x[:, 9:]), h, state=st)
    _module_close(torch.cat([a, b], 1), want)
    ref_a, ref_st = ref_xlstm.slstm_scan(ref_p, jnp.asarray(x[:, :9]), h)
    ref_b, _ = ref_xlstm.slstm_scan(ref_p, jnp.asarray(x[:, 9:]), h,
                                    state=ref_st)
    _module_close(b, ref_b)


def test_init_states_match_reference():
    got_m = xlstm.init_mlstm_state(3, 32, 4, 2.0, dtype=torch.float32,
                                   device="cpu")
    want_m = ref_xlstm.init_mlstm_state(3, 32, 4, 2.0, dtype=jnp.float32)
    got_s = xlstm.init_slstm_state(3, 32, device="cpu")
    want_s = ref_xlstm.init_slstm_state(3, 32)
    for got, want in ((got_m, want_m), (got_s, want_s)):
        g, _ = tree_flatten(got)
        w = jax.tree_util.tree_leaves(want)
        assert len(g) == len(w)
        for a, c in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    # four tensors, not one zero tensor three times: decode writes them
    ptrs = {t.data_ptr() for t in got_s.values()}
    assert len(ptrs) == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            xlstm.init_slstm_state(1, 8)


def _block_state(kind, b, d, h, rng):
    """A random state of the kind the block carries (a decode cache
    after some steps)."""
    if kind == "mlstm":
        di = 2 * d
        dh = di // h
        return {"mem": (rng.standard_normal((b, h, dh, dh)).astype(
                            np.float32) * 0.1,
                        rng.standard_normal((b, h, dh)).astype(np.float32),
                        rng.standard_normal((b, h)).astype(np.float32)),
                "conv": rng.standard_normal((b, 3, di)).astype(np.float32)}
    return {"c": rng.standard_normal((b, d)).astype(np.float32),
            "n": np.abs(rng.standard_normal((b, d))).astype(np.float32),
            "m": rng.standard_normal((b, d)).astype(np.float32),
            "h": rng.standard_normal((b, d)).astype(np.float32) * 0.1}


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 24])
def test_blocks_match_reference(kind, with_state, s):
    """``mlstm_block`` (chunks of 8: three at S = 24; one step at S = 1,
    the decode shape) and ``slstm_block``, with and without a state in;
    outputs and the states out."""
    d, h, b = 32, 4, 2
    rng = np.random.default_rng(7 + s)
    key = jax.random.PRNGKey(3)
    if kind == "mlstm":
        ref_p = jax.device_get(ref_xlstm.init_mlstm(key, d, h, 2.0))
    else:
        ref_p = jax.device_get(ref_xlstm.init_slstm(key, d, h))
    p = bridge.from_reference(ref_p, "cpu")
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    state = _block_state(kind, b, d, h, rng) if with_state else None
    ref_state = None if state is None else jax.tree_util.tree_map(
        jnp.asarray, state)
    pt_state = None if state is None else bridge.from_reference(state,
                                                                "cpu")
    if kind == "mlstm":
        want, want_st = ref_xlstm.mlstm_block(ref_p, jnp.asarray(x), h,
                                              state=ref_state, chunk=8)
        got, got_st = xlstm.mlstm_block(p, torch.from_numpy(x), h,
                                        state=pt_state, chunk=8)
    else:
        want, want_st = ref_xlstm.slstm_block(ref_p, jnp.asarray(x), h,
                                              state=ref_state)
        got, got_st = xlstm.slstm_block(p, torch.from_numpy(x), h,
                                        state=pt_state)
    _module_close(got, want)
    g_leaves, _ = tree_flatten(got_st)
    w_leaves = jax.tree_util.tree_leaves(want_st)
    assert len(g_leaves) == len(w_leaves)
    for a, w in zip(g_leaves, w_leaves):
        _module_close(a, w)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_blocks_in_bf16_keep_the_reference_dtypes(kind):
    """bf16 weights and input: the output and the conv state in bf16,
    the mLSTM memory and the sLSTM state in f32 (the cells run in f32),
    values at the reference's bf16 roundings."""
    d, h, b, s = 32, 4, 2, 16
    key = jax.random.PRNGKey(4)
    if kind == "mlstm":
        ref_p = ref_xlstm.init_mlstm(key, d, h, 2.0, dtype=jnp.bfloat16)
    else:
        ref_p = ref_xlstm.init_slstm(key, d, h, dtype=jnp.bfloat16)
    p = bridge.from_reference(jax.device_get(ref_p), "cpu")
    x = np.random.default_rng(5).standard_normal((b, s, d)).astype(
        ml_dtypes.bfloat16)
    if kind == "mlstm":
        want, want_st = ref_xlstm.mlstm_block(ref_p, jnp.asarray(x), h,
                                              chunk=8)
        got, got_st = xlstm.mlstm_block(p, bridge.to_torch(x, "cpu"), h,
                                        chunk=8)
    else:
        want, want_st = ref_xlstm.slstm_block(ref_p, jnp.asarray(x), h)
        got, got_st = xlstm.slstm_block(p, bridge.to_torch(x, "cpu"), h)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    g_leaves, _ = tree_flatten(got_st)
    w_leaves = jax.tree_util.tree_leaves(want_st)
    assert [str(t.dtype).removeprefix("torch.") for t in g_leaves] == \
        [str(w.dtype) for w in w_leaves]
    _module_close(got, np.asarray(want, np.float32), 2e-2)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_model_has_the_reference_tree_and_biases(dtype):
    """Keys, shapes and dtypes of reduced xlstm-350m (one stacked block
    of an (mLSTM, sLSTM, MLP) triple a pair of layers), and the fixed
    initial values (norm scales, gate biases) equal to the reference's."""
    cfg = get_arch(ARCH).reduced()
    mine = init_model(cfg, torch.Generator().manual_seed(0),
                      getattr(torch, dtype))
    ref = jax.device_get(ref_init_model(ref_get_arch(ARCH).reduced(),
                                        jax.random.PRNGKey(0),
                                        dtype=getattr(jnp, dtype)))
    leaves, treedef = tree_flatten(mine)
    ref_leaves = jax.tree_util.tree_leaves(ref)
    assert treedef == tree_flatten(bridge.from_reference(
        jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                               ref), "cpu"))[1]
    assert [tuple(t.shape) for t in leaves] == \
        [tuple(a.shape) for a in ref_leaves]
    assert [str(t.dtype).removeprefix("torch.") for t in leaves] == \
        [str(a.dtype) for a in ref_leaves]
    assert mine["blocks"]["ln1"].shape[0] == cfg.num_layers // 2 == 1
    with pytest.raises(ValueError, match="even num_layers"):
        init_model(dataclasses.replace(cfg, num_layers=3),
                   torch.Generator().manual_seed(0))
    blocks, ref_blocks = mine["blocks"], ref["blocks"]
    for path in (("mlstm", "b_if"), ("mlstm", "hnorm"), ("slstm", "b"),
                 ("slstm", "hnorm"), ("ln1",), ("ln2",), ("ln3",)):
        a, w = blocks, ref_blocks
        for k in path:
            a, w = a[k], w[k]
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(w, np.float32), rtol=1e-6)


def test_param_count_is_the_reference_count_not_the_tree():
    """``config/base.py: _xlstm_params`` counts something else than the
    model's tree (a fault of the reference, copied unchanged): both
    packages give the same ``param_count()``; the real full-width tree
    has per pair 18.90 M (mLSTM), 5.25 M (sLSTM) and 2.80 M (MLP)
    parameters, 51.5 M each in the embedding and the head."""
    cfg, ref_cfg = get_arch(ARCH), ref_get_arch(ARCH)
    assert cfg.param_count() == ref_cfg.param_count()
    shapes = jax.eval_shape(lambda: ref_init_model(
        ref_cfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    count = {k: sum(int(np.prod(a.shape)) for a in
                    jax.tree_util.tree_leaves(v))
             for k, v in shapes["blocks"].items()}
    pairs = cfg.num_layers // 2
    assert round(count["mlstm"] / pairs / 1e4) == 1890
    assert round(count["slstm"] / pairs / 1e4) == 525
    assert round(count["mlp"] / pairs / 1e4) == 280
    assert int(np.prod(shapes["embed"].shape)) == \
        int(np.prod(shapes["head"].shape)) == 51_511_296
    tree = sum(int(np.prod(a.shape)) for a in
               jax.tree_util.tree_leaves(shapes))
    assert tree != cfg.param_count()


@pytest.mark.parametrize("s,ssm_chunk", [(48, 16), (48, 40)])
def test_forward_lm_loss_and_grads_match_reference(s, ssm_chunk):
    """Forward logits, and ``lm_loss`` with its gradient against
    ``jax.grad``: three mLSTM chunks at S = 48 with chunks of 16, one
    (the fallback) with chunks of 40."""
    ref_p, p = _params()
    cfg, ref_cfg = get_arch(ARCH).reduced(), ref_get_arch(ARCH).reduced()
    toks = _tokens(2, s, seed=s + ssm_chunk)
    got, aux = forward(cfg, p, {"tokens": torch.from_numpy(toks)},
                       ssm_chunk=ssm_chunk)
    want, want_aux = ref_forward(ref_cfg, ref_p,
                                 {"tokens": jnp.asarray(toks)},
                                 ssm_chunk=ssm_chunk)
    assert float(aux) == float(want_aux) == 0.0
    _module_close(got, want, 1e-4)
    (ref_loss, _), ref_g = jax.value_and_grad(
        lambda q: ref_lm_loss(ref_cfg, q, {"tokens": jnp.asarray(toks)},
                              ssm_chunk=ssm_chunk), has_aux=True)(ref_p)
    loss, _, grads = steps.loss_and_grads(
        lambda q: lm_loss(cfg, q, {"tokens": torch.from_numpy(toks)},
                          ssm_chunk=ssm_chunk), p)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    got_g = tree_leaves(grads)
    want_g = jax.tree_util.tree_leaves(ref_g)
    assert len(got_g) == len(want_g)
    for a, w in zip(got_g, want_g):
        w = np.asarray(w)
        np.testing.assert_allclose(
            a.numpy(), w, rtol=1e-4,
            atol=1e-4 * max(1.0, float(np.abs(w).max())))


def test_decode_state_pins_the_reference_stabilizers():
    """``init_decode_state``: the mLSTM stabilizer at NEG, the sLSTM's
    at 0 (the reference's ``_refill_pos`` re-fills only the tuple
    ``mem``; ``s["m"]`` was overwritten by the zeros-stacking), leaf for
    leaf equal to the reference's; and an sLSTM step that starts there
    is the reference's, not the one that starts from ``NEG``."""
    cfg, ref_cfg = get_arch(ARCH).reduced(), ref_get_arch(ARCH).reduced()
    state = init_decode_state(cfg, 2, 8, dtype=torch.float32, device="cpu")
    ref_state = ref_init_decode_state(ref_cfg, 2, 8, dtype=jnp.float32)
    layers = state["layers"]
    neg = float(np.float32(xlstm.NEG))
    assert float(layers["m"]["mem"][2].max()) == neg
    assert float(layers["s"]["m"].abs().max()) == 0.0
    g, _ = tree_flatten(layers)
    w = jax.tree_util.tree_leaves(ref_state["layers"])
    for a, c in zip(g, w):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    # the sLSTM's first step from m = 0 is the reference's; on inputs
    # whose input gate falls far under the forget gate (i < 1e-6, where
    # n is clamped) it differs from the step that starts from NEG
    d, h = 32, 4
    ref_p, p = _slstm_params(d, h)
    x = np.random.default_rng(6).standard_normal((2, 1, d)).astype(
        np.float32) * 30.0
    zero_m = xlstm.init_slstm_state(2, d, device="cpu")
    zero_m["m"].zero_()
    got, _ = xlstm.slstm_scan(p, torch.from_numpy(x), h, state=zero_m)
    ref_zero = dict(ref_xlstm.init_slstm_state(2, d))
    ref_zero["m"] = jnp.zeros((2, d), jnp.float32)
    want, _ = ref_xlstm.slstm_scan(ref_p, jnp.asarray(x), h, state=ref_zero)
    _module_close(got, want)
    from_neg, _ = xlstm.slstm_scan(p, torch.from_numpy(x), h)
    assert not torch.allclose(from_neg, got, rtol=1e-3, atol=1e-3)


def test_decode_matches_reference_decode_step():
    ref_p, p = _params()
    cfg, ref_cfg = get_arch(ARCH).reduced(), ref_get_arch(ARCH).reduced()
    toks = _tokens(2, 6, seed=1)
    state = init_decode_state(cfg, 2, 6, dtype=torch.float32, device="cpu")
    ref_state = ref_init_decode_state(ref_cfg, 2, 6, dtype=jnp.float32)
    for t in range(6):
        got, state = decode_step(cfg, p, state,
                                 torch.from_numpy(toks[:, t:t + 1]))
        want, ref_state = ref_decode_step(ref_cfg, ref_p, ref_state,
                                          jnp.asarray(toks[:, t:t + 1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)
    g, _ = tree_flatten(state["layers"])
    w = jax.tree_util.tree_leaves(ref_state["layers"])
    for a, c in zip(g, w):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=2e-4,
                                   atol=2e-4 * max(1.0, float(np.abs(
                                       np.asarray(c)).max())))
    assert state["pos"] == int(ref_state["pos"]) == 6


def test_decode_writes_the_cache_in_place():
    """The xLSTM states are copied into the stacked caches' storage (the
    tensors of the state passed in), never rebound."""
    _, p = _params()
    cfg = get_arch(ARCH).reduced()
    state = init_decode_state(cfg, 1, 4, dtype=torch.float32, device="cpu")
    leaves = tree_leaves(state["layers"])
    ptrs = [t.data_ptr() for t in leaves]
    before = [t.clone() for t in leaves]
    toks = torch.from_numpy(_tokens(1, 2, seed=5))
    for t in range(2):
        _, returned = decode_step(cfg, p, state, toks[:, t:t + 1])
        assert returned is state and state["pos"] == t + 1
    after = tree_leaves(state["layers"])
    assert [t.data_ptr() for t in after] == ptrs
    assert all(not torch.equal(a, b) for a, b in zip(after, before))


def test_decode_matches_forward_in_the_port():
    """Decoding a prompt one token at a time through the mLSTM memory,
    its conv state and the sLSTM state reproduces the forward's logits
    at every position; the forward crosses mLSTM chunk boundaries
    (S = 64, chunks of 16)."""
    _, p = _params()
    cfg = get_arch(ARCH).reduced()
    s = 64
    toks = torch.from_numpy(_tokens(1, s, seed=2))
    full, _ = forward(cfg, p, {"tokens": toks}, ssm_chunk=16)
    state = init_decode_state(cfg, 1, s, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(s):
        lg, state = decode_step(cfg, p, state, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-4, atol=2e-4)
