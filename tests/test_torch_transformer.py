"""The port's LM serving slice (``models/{layers,rope,transformer}.py``,
``launch/steps.py``, ``launch/serve.py``) against the JAX package's:
reduced ``llama3.2-1b`` (dense), ``hymba-1.5b`` (hybrid),
``mixtral-8x7b`` and ``arctic-480b`` (MoE, the second with its dense
residual) and ``xlstm-350m`` (ssm: mLSTM / sLSTM pairs), parameters
made by the reference's ``init_model`` and carried across with
``bridge.from_reference``, the same numpy tokens on both sides.

Tolerances: 1e-5 for the layers (f32 elementwise, one reduction); 1e-4
for whole-model logits (f32 matmuls and softmax sums in another order
through two layers), 2e-4 for the hybrid family's decode against its
forward, as ``tests/test_decode_consistency.py`` states.  S=512 puts the
chunked (llama) and banded (hymba, window 64) attention branches on the
path, not only the naive one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.config import get_arch as ref_get_arch
from repro.config.base import INPUT_SHAPES as REF_SHAPES
from repro.config.base import TrainConfig as RefTrainConfig
from repro.launch import steps as ref_steps
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_decode_state as ref_init_decode_state
from repro.models import init_model as ref_init_model
from repro.models import layers as ref_layers
from repro.models.rope import apply_rope as ref_apply_rope
from repro_torch import bridge
from repro_torch.config import get_arch
from repro_torch.config.base import INPUT_SHAPES, InputShape, TrainConfig
from repro_torch.launch import serve, steps
from repro_torch.models import (decode_step, forward, init_decode_state,
                                init_model, layers)
from repro_torch.models.rope import apply_rope
from repro_torch.tree import tree_flatten

torch.set_num_threads(1)

ARCHS = ["llama3.2-1b", "hymba-1.5b", "mixtral-8x7b", "arctic-480b",
         "xlstm-350m"]
_PARAMS = {}


def _params(arch):
    """(reference params as jax arrays, the port's bridged copy)."""
    if arch not in _PARAMS:
        cfg = ref_get_arch(arch).reduced()
        ref = ref_init_model(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
        _PARAMS[arch] = (ref, bridge.from_reference(jax.device_get(ref),
                                                    "cpu"))
    return _PARAMS[arch]


def _tokens(arch, b, s, seed=0):
    cfg = get_arch(arch).reduced()
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# layers and rope
# ---------------------------------------------------------------------------

def test_rms_norm_and_layer_norm_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32) * 0.1
    bias = rng.standard_normal(32).astype(np.float32)
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale)), 1e-5)
    _close(layers.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                             torch.from_numpy(bias)),
           ref_layers.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                 jnp.asarray(bias)), 1e-5)
    # bf16 in, bf16 out; the math is f32 inside
    xb = x.astype(ml_dtypes.bfloat16)
    got = layers.rms_norm(bridge.to_torch(xb, "cpu"), torch.from_numpy(scale))
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(ref_layers.rms_norm(jnp.asarray(xb),
                                               jnp.asarray(scale)),
                           np.float32), 1e-2)


@pytest.mark.parametrize("kind", ["swiglu", "gelu", "squared_relu", "relu"])
def test_mlp_matches_reference(kind):
    ref_p = jax.device_get(ref_layers.init_mlp(jax.random.PRNGKey(1), 16, 48,
                                               kind))
    x = np.random.default_rng(1).standard_normal((2, 3, 16)).astype(
        np.float32)
    got = layers.mlp(bridge.from_reference(ref_p, "cpu"), torch.from_numpy(x),
                     kind)
    want = ref_layers.mlp(jax.tree_util.tree_map(jnp.asarray, ref_p),
                          jnp.asarray(x), kind)
    _close(got, want, 1e-5)
    mine = layers.init_mlp(torch.Generator().manual_seed(0), 16, 48, kind)
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: v.shape for k, v in ref_p.items()}


@pytest.mark.parametrize("theta,offset", [(10_000.0, 0), (500_000.0, 37)])
def test_apply_rope_matches_reference(theta, offset):
    x = np.random.default_rng(2).standard_normal((2, 9, 4, 32)).astype(
        np.float32)
    pos = (np.arange(9) + offset)[None]
    _close(apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           ref_apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), 1e-5)
    xb = x.astype(ml_dtypes.bfloat16)
    got = apply_rope(bridge.to_torch(xb, "cpu"), torch.from_numpy(pos), theta)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(ref_apply_rope(jnp.asarray(xb), jnp.asarray(pos),
                                          theta), np.float32), 2e-2)


def test_dense_init_is_a_truncated_normal_with_fan_in_scale():
    w = layers.dense_init(torch.Generator().manual_seed(0), (400, 300))
    assert float(w.abs().max()) <= 2.0 / 20.0 + 1e-7
    assert abs(float(w.std()) * 20.0 - 0.88) < 0.02   # std of N(0,1) cut at 2


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_model_has_the_reference_tree(arch, dtype):
    cfg = get_arch(arch).reduced()
    mine = init_model(cfg, torch.Generator().manual_seed(0),
                      getattr(torch, dtype))
    ref = jax.eval_shape(lambda: ref_init_model(
        ref_get_arch(arch).reduced(), jax.random.PRNGKey(0),
        dtype=getattr(jnp, dtype)))
    leaves, treedef = tree_flatten(mine)
    ref_leaves, _ = jax.tree_util.tree_flatten(ref)
    assert treedef == tree_flatten(bridge.from_reference(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                               ref), "cpu"))[1]
    assert [tuple(t.shape) for t in leaves] == \
        [tuple(s.shape) for s in ref_leaves]
    assert [str(t.dtype).removeprefix("torch.") for t in leaves] == \
        [str(s.dtype) for s in ref_leaves]


def test_other_families_wait_for_a_later_slice():
    """No LM family of the reference waits any more: audio runs since its
    slice (frames in, per-frame logits out; ``tests/test_torch_audio.py``
    holds it against the reference).  A family outside ``FAMILIES`` (the
    CNNs) still raises ``ValueError`` at every entry."""
    base = get_arch("llama3.2-1b").reduced()
    gen = torch.Generator().manual_seed(0)
    cfg = dataclasses.replace(base, family="audio", causal=False)
    p = init_model(cfg, gen)
    frames = torch.randn(2, 8, cfg.d_model, generator=gen)
    logits, aux = forward(cfg, p, {"frames": frames})
    assert tuple(logits.shape) == (2, 8, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()) and float(aux) == 0.0
    assert init_decode_state(cfg, 1, 4, device="cpu")["pos"] == 0
    cnn = dataclasses.replace(base, family="cnn")
    with pytest.raises(ValueError, match="not a language model"):
        init_model(cnn, gen)
    with pytest.raises(ValueError, match="not a language model"):
        forward(cnn, {}, {"tokens": torch.zeros(1, 4, dtype=torch.long)})
    with pytest.raises(ValueError, match="not a language model"):
        init_decode_state(cnn, 1, 4, device="cpu")


# ---------------------------------------------------------------------------
# forward and decode from bridged reference parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s", [16, 512])
def test_forward_matches_reference(arch, s):
    ref_p, p = _params(arch)
    toks = _tokens(arch, 1, s)
    got, aux = forward(get_arch(arch).reduced(), p,
                       {"tokens": torch.from_numpy(toks)})
    want, want_aux = ref_forward(ref_get_arch(arch).reduced(), ref_p,
                                 {"tokens": jnp.asarray(toks)})
    # the summed load-balance losses of the MoE layers; 0 elsewhere
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * max(
        1.0, abs(float(want_aux)))
    assert (float(aux) == 0.0) == (get_arch(arch).family != "moe")
    _close(got, want, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch):
    ref_p, p = _params(arch)
    cfg, ref_cfg = get_arch(arch).reduced(), ref_get_arch(arch).reduced()
    toks = _tokens(arch, 2, 6, seed=1)
    state = init_decode_state(cfg, 2, 6, dtype=torch.float32, device="cpu")
    ref_state = ref_init_decode_state(ref_cfg, 2, 6, dtype=jnp.float32)
    for t in range(6):
        got, state = decode_step(cfg, p, state, torch.from_numpy(
            toks[:, t:t + 1]))
        want, ref_state = ref_decode_step(ref_cfg, ref_p, ref_state,
                                          jnp.asarray(toks[:, t:t + 1]))
        _close(got, want, 1e-4)
    assert state["pos"] == int(ref_state["pos"]) == 6


def test_decode_step_advances_the_state_it_was_given():
    """The caches are written in place, so ``pos`` advances in place too:
    the state passed in and the state returned are one object."""
    _, p = _params("hymba-1.5b")
    cfg = get_arch("hymba-1.5b").reduced()
    state = init_decode_state(cfg, 1, 4, dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(_tokens("hymba-1.5b", 1, 2, seed=5))
    for t in range(2):
        _, returned = decode_step(cfg, p, state, toks[:, t:t + 1])
        assert returned is state and state["pos"] == t + 1


@pytest.mark.parametrize("arch,tol",[("llama3.2-1b", 1e-4),
                                      ("hymba-1.5b", 2e-4)])
def test_decode_matches_forward_in_the_port(arch, tol):
    """Decoding a prompt step by step through the KV ring cache (hymba:
    64 slots, the reduced window) and the SSM state reproduces the
    forward's logits at every position; at S=512 the forward takes the
    chunked (llama) or banded (hymba) branch."""
    _, p = _params(arch)
    cfg = get_arch(arch).reduced()
    s = 512
    toks = torch.from_numpy(_tokens(arch, 1, s, seed=2))
    full, _ = forward(cfg, p, {"tokens": toks})
    state = init_decode_state(cfg, 1, s, dtype=torch.float32, device="cpu")
    kv_len = state["layers"]["kv"]["k"].shape[2]
    assert kv_len == (cfg.sliding_window or s)
    outs = []
    for t in range(s):
        lg, state = decode_step(cfg, p, state, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=tol, atol=tol)


def test_init_decode_state_matches_reference_and_needs_a_device():
    for arch in ARCHS:
        cfg, ref_cfg = get_arch(arch).reduced(), ref_get_arch(arch).reduced()
        got = init_decode_state(cfg, 3, 100, dtype=torch.float32,
                                device="cpu")
        want = ref_init_decode_state(ref_cfg, 3, 100, dtype=jnp.float32)
        g_leaves, _ = tree_flatten(got["layers"])
        w_leaves = jax.tree_util.tree_leaves(want["layers"])
        assert [tuple(t.shape) for t in g_leaves] == \
            [w.shape for w in w_leaves]
        for g, w in zip(g_leaves, w_leaves):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got["pos"] == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            init_decode_state(get_arch("llama3.2-1b").reduced(), 1, 8)


# ---------------------------------------------------------------------------
# launch/steps.py and launch/serve.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_make_prefill_step_matches_reference(arch):
    ref_p, p = _params(arch)
    toks = _tokens(arch, 2, 512, seed=3)
    got = steps.make_prefill_step(get_arch(arch).reduced(), TrainConfig())(
        p, {"tokens": torch.from_numpy(toks)})
    want = ref_steps.make_prefill_step(ref_get_arch(arch).reduced(),
                                       RefTrainConfig())(
        ref_p, {"tokens": jnp.asarray(toks)})
    assert tuple(got.shape) == want.shape
    _close(got, want, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_and_loop_match_reference(arch):
    ref_p, p = _params(arch)
    cfg, ref_cfg = get_arch(arch).reduced(), ref_get_arch(arch).reduced()
    shape = InputShape("serve", 16, 2, "decode")
    ref_shape = dataclasses.replace(REF_SHAPES["decode_32k"], seq_len=16,
                                    global_batch=2)
    toks = _tokens(arch, 2, 1, seed=4)
    state = init_decode_state(cfg, 2, 16, dtype=torch.float32, device="cpu")
    ref_state = ref_init_decode_state(ref_cfg, 2, 16, dtype=jnp.float32)
    got, state = steps.make_serve_step(cfg, shape)(
        p, state, {"tokens": torch.from_numpy(toks)})
    want, ref_state = ref_steps.make_serve_step(ref_cfg, ref_shape)(
        ref_p, ref_state, {"tokens": jnp.asarray(toks)})
    _close(got, want, 1e-4)
    loop_got, state = steps.make_serve_loop(cfg, shape, n_steps=4)(
        p, state, {"tokens": torch.from_numpy(toks)})
    loop_want, _ = ref_steps.make_serve_loop(ref_cfg, ref_shape,
                                             n_steps=4)(
        ref_p, ref_state, {"tokens": jnp.asarray(toks)})
    assert tuple(loop_got.shape) == loop_want.shape == (4, 2, cfg.vocab_size)
    _close(loop_got, loop_want, 1e-4)
    assert state["pos"] == 5


def test_swa_window_and_model_flops_match_reference():
    for arch in ARCHS:
        cfg, ref_cfg = get_arch(arch), ref_get_arch(arch)
        for name, shape in INPUT_SHAPES.items():
            assert steps.swa_window_for(cfg, shape) == \
                ref_steps.swa_window_for(ref_cfg, REF_SHAPES[name])
            assert steps.model_flops(cfg, shape) == \
                ref_steps.model_flops(ref_cfg, REF_SHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_the_cpu(arch, capsys):
    argv = ["--device", "cpu", "--arch", arch, "--batch", "2",
            "--prompt-len", "8", "--gen", "5"]
    toks = serve.main(argv)
    out = capsys.readouterr().out
    assert f"[serve] {arch}-reduced: prefill 8 toks" in out
    cfg = get_arch(arch).reduced()
    assert toks.shape == (2, 5)
    assert toks.min() >= 0 and toks.max() < cfg.vocab_size
    assert np.array_equal(serve.main(argv), toks)      # seeded
    sampled = serve.main(argv + ["--temperature", "0.8"])
    assert sampled.shape == (2, 5)


def test_serve_cli_raises_without_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "llama3.2-1b", "--gen", "1"])
