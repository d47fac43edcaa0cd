"""The port's audio and VLM families (``models/transformer.py`` with
``family="audio"``, ``launch/steps.py: input_specs``, ``launch/serve.py``;
configs ``hubert-xlarge`` and ``chameleon-34b``) against the JAX
package's.

hubert-xlarge is an encoder over frames: ``batch["frames"]`` (B,S,d)
enter in place of embedded tokens, the attention is non-causal with no
window, the loss takes per-frame ``labels`` with no shift, and there is
no decode step.  Its head dim is 1280 / 16 = 80, which K4 has its own
instantiations for; the reduced config has D = 64, so the same config
with ``d_model = 320`` and ``head_dim = 80`` holds D = 80 here too.  S =
16 takes attention's naive branch, S = 512 its chunked one (the
kernel's route on the card).  Parameters are made by the reference's
``init_model`` and carried across with ``bridge.from_reference``; frames
and labels are drawn with numpy from a seed, the same on both sides.

Tolerances, as ``tests/test_torch_transformer.py`` and
``tests/test_torch_lm_train.py`` hold the other families: logits 1e-4;
the loss 1e-5; gradients 1e-4 relative to each leaf's largest entry;
K4's plain twins 2e-5 (forward) and 1e-4 (gradients, the rows'
log-sum-exp), as ``tests/test_torch_wide_heads.py``.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as ref_get_arch
from repro.config.base import INPUT_SHAPES as REF_SHAPES
from repro.config.base import TrainConfig as RefTrainConfig
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.ref import flash_attention_ref
from repro.launch import steps as ref_steps
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_decode_state as ref_init_decode_state
from repro.models import init_model as ref_init_model
from repro.models import lm_loss as ref_lm_loss
from repro_torch import bridge
from repro_torch.config import get_arch
from repro_torch.config.base import INPUT_SHAPES, TrainConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve, steps
from repro_torch.models import (decode_step, forward, init_decode_state,
                                lm_loss)
from repro_torch.tree import tree_flatten, tree_leaves

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
AUDIO = "hubert-xlarge"
VLM = "chameleon-34b"


def _audio_cfgs(d):
    """(port config, reference config): hubert reduced at head dim 64,
    or widened to d_model 320 with head dim 80."""
    cfgs = (get_arch(AUDIO).reduced(), ref_get_arch(AUDIO).reduced())
    if d == 80:
        cfgs = tuple(dataclasses.replace(c, d_model=320, head_dim=80)
                     for c in cfgs)
    assert cfgs[0].head_dim == d and not cfgs[0].causal
    assert dataclasses.asdict(cfgs[0]) == dataclasses.asdict(cfgs[1])
    return cfgs


_PARAMS = {}


def _params(d):
    """(reference params as jax arrays, the port's bridged copy)."""
    if d not in _PARAMS:
        ref = ref_init_model(_audio_cfgs(d)[1], jax.random.PRNGKey(d),
                             dtype=jnp.float32)
        _PARAMS[d] = (ref, bridge.from_reference(jax.device_get(ref), "cpu"))
    return _PARAMS[d]


def _batch(cfg, b, s, seed=0):
    """Frames (B,S,d) f32 and per-frame labels (B,S), numpy."""
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal((b, s, cfg.d_model))
            .astype(np.float32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s))}


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _grads_close(got_tree, want_tree, rtol=1e-4):
    got = tree_leaves(got_tree)
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.detach().numpy(), w, rtol=rtol,
            atol=rtol * max(1.0, float(np.abs(w).max())))


# ---------------------------------------------------------------------------
# hubert: forward, loss and gradients against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("s", [16, 512])
def test_hubert_forward_matches_reference(d, s):
    cfg, ref_cfg = _audio_cfgs(d)
    ref_p, p = _params(d)
    batch = _batch(cfg, 2, s, seed=s)
    got, aux = forward(cfg, p, _to_torch(batch))
    want, want_aux = ref_forward(ref_cfg, ref_p, _to_jax(batch))
    assert tuple(got.shape) == (2, s, cfg.vocab_size)
    assert float(aux) == float(want_aux) == 0.0
    _close(got, want, 1e-4)


@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("s", [16, 512])
def test_hubert_lm_loss_and_grads_match_jax_grad(d, s):
    """Per-frame labels, no shift; the loss the mean over B * S frames;
    the gradient of every parameter against ``jax.grad``."""
    cfg, ref_cfg = _audio_cfgs(d)
    ref_p, p = _params(d)
    batch = _batch(cfg, 2, s, seed=s + 1)
    (ref_loss, _), ref_g = jax.value_and_grad(
        lambda q: ref_lm_loss(ref_cfg, q, _to_jax(batch)),
        has_aux=True)(ref_p)
    loss, aux, grads = steps.loss_and_grads(
        lambda q: lm_loss(cfg, q, _to_torch(batch)), p)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    assert float(aux) == 0.0
    _grads_close(grads, ref_g)


def test_hubert_loss_takes_every_frame_unshifted():
    """The encoder's loss is the mean cross entropy of each frame's
    logits against its own label (no shift, no frame dropped), chunked
    or not."""
    cfg, _ = _audio_cfgs(64)
    _, p = _params(64)
    batch = _to_torch(_batch(cfg, 2, 64, seed=3))
    logits, _ = forward(cfg, p, batch)
    want = torch.nn.functional.cross_entropy(
        logits.reshape(-1, cfg.vocab_size), batch["labels"].reshape(-1))
    for chunk in (64, 16):
        got, _ = lm_loss(cfg, p, batch, loss_chunk=chunk)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_hubert_make_train_step_matches_reference():
    """One AdamW step (f32, clip 1.0) on frames and labels at S = 512:
    loss and grad norm tight, parameters within one ``lr``; two seeded
    runs of the port's step are the same bits."""
    cfg, ref_cfg = _audio_cfgs(80)
    tc = dict(dtype="float32", remat=False, attn_chunk_q=128,
              attn_chunk_kv=128)
    batch = _batch(cfg, 2, 512, seed=9)
    ref_p = _params(80)[0]
    ref_step, ref_opt = ref_steps.make_train_step(ref_cfg,
                                                  RefTrainConfig(**tc))
    ref_new, _, ref_m = ref_step(ref_p, ref_opt.init(ref_p), _to_jax(batch))
    runs = []
    for _ in range(2):
        p = bridge.from_reference(jax.device_get(ref_p), "cpu")
        step, opt = steps.make_train_step(cfg, TrainConfig(**tc))
        new, state, m = step(p, opt.init(p), _to_torch(batch))
        runs.append((new, m))
    (new, m), (again, _) = runs
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(ref_m["grad_norm"]), rtol=1e-4)
    lr = TrainConfig().lr
    diffs = [np.abs(a.numpy() - np.asarray(b)) for a, b in
             zip(tree_leaves(new), jax.tree_util.tree_leaves(ref_new))]
    assert max(float(x.max()) for x in diffs) <= lr * 1.001
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(new),
                                                 tree_leaves(again)))


def test_hubert_attention_is_one_kernel_call_a_layer_on_the_kernel_route(
        monkeypatch):
    """At S = 512 every layer's attention takes the chunked branch, which
    on the card is one K4 launch (causal=False, no window, D = 80, k and
    v not repeated): routed here on the CPU, the op recorded."""
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.models import attention as attn_lib
    cfg, _ = _audio_cfgs(80)
    _, p = _params(80)
    calls = []
    real = kernel_ops.gqa_flash_attention

    def recording(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw))
        return real(q, k, v, **kw)

    with monkeypatch.context() as mp:
        mp.setattr(attn_lib, "_kernel_route", lambda *a: True)
        mp.setattr(kernel_ops, "gqa_flash_attention", recording)
        got, _ = forward(cfg, p, _to_torch(_batch(cfg, 1, 512, seed=4)))
    want, _ = forward(cfg, p, _to_torch(_batch(cfg, 1, 512, seed=4)))
    assert len(calls) == cfg.num_layers
    for qs, ks, kw in calls:
        assert qs == (1, 512, cfg.n_heads, 80)
        assert ks == (1, 512, cfg.n_kv_heads, 80)
        assert kw.get("causal") is False and not kw.get("window")
    _close(got, want.numpy(), 1e-5)


# ---------------------------------------------------------------------------
# K4's plain twins at D = 80 against the Pallas kernel and jax.grad
# ---------------------------------------------------------------------------

# (b, s, t, h, hkv, causal, window, q_offset): hubert's non-causal MHA,
# a GQA group of 2 non-causal over T > S, and rows that see no key
# beside rows that do
D80_CASES = [(2, 64, 64, 4, 4, False, 0, 0),
             (1, 64, 96, 4, 2, False, 0, 0),
             (1, 64, 128, 2, 1, False, 32, 140)]


def _case(seed, b, s, t, h, hkv):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, 80), (b, t, hkv, 80), (b, t, hkv, 80),
                          (b, s, h, 80))]


@pytest.mark.parametrize("case", D80_CASES)
def test_d80_plain_twin_matches_pallas_kernel(case):
    b, s, t, h, hkv, causal, window, q_offset = case
    q, k, v, _ = _case(sum(case), b, s, t, h, hkv)
    rep = h // hkv
    kw = dict(causal=causal, window=window, q_offset=q_offset)

    def fold(x):
        x = np.repeat(x, rep, axis=2) if x.shape[2] != h else x
        return np.moveaxis(x, 2, 1).reshape(b * h, -1, 80)

    want = ref_flash(jnp.asarray(fold(q)), jnp.asarray(fold(k)),
                     jnp.asarray(fold(v)), block_q=32, block_k=32,
                     interpret=True, **kw)
    got = fa.flash_attention_plain(*(torch.from_numpy(fold(x))
                                     for x in (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    # the model layout (kv heads not repeated) is the same twin
    gqa = fa.gqa_plain(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    np.testing.assert_allclose(
        gqa.movedim(2, 1).reshape(b * h, s, 80).numpy(), got.numpy(),
        rtol=0, atol=0)


@pytest.mark.parametrize("case", D80_CASES)
def test_d80_bwd_plain_matches_jax_grad(case):
    """The forward with lse and the backward twin against ``jax.grad`` of
    the reference's oracle on k/v repeated per group (dk, dv summed back
    over each group); the autograd Function on CPU tensors carries the
    same gradients."""
    b, s, t, h, hkv, causal, window, q_offset = case
    q, k, v, do = _case(sum(case) + 1, b, s, t, h, hkv)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    rep = h // hkv

    def fold(x):
        return jnp.moveaxis(x, 2, 1).reshape(b * x.shape[2], x.shape[1], 80)

    def attend(q, k, v):
        kx, vx = jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2)
        o = flash_attention_ref(fold(q), fold(kx), fold(vx), **kw)
        return jnp.moveaxis(o.reshape(b, h, s, 80), 1, 2)

    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want_out = attend(jq, jk, jv)
    want = jax.grad(lambda *a: jnp.sum(attend(*a) * do),
                    argnums=(0, 1, 2))(jq, jk, jv)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = fa.flash_attention_fwd_plain(qt, kt, vt, **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_out), rtol=2e-5,
                               atol=2e-5)
    got = fa.flash_attention_bwd_plain(qt, kt, vt, o, lse,
                                       torch.from_numpy(do), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    ins = [x.clone().requires_grad_(True) for x in (qt, kt, vt)]
    out = fa.flash_attention(*ins, **kw)
    for g, w in zip(torch.autograd.grad(out, ins, torch.from_numpy(do)),
                    got):
        assert torch.equal(g, w)


def test_d80_is_instantiated_in_every_k4_kernel():
    """D = 80 is in ``HEAD_DIMS`` and in the dispatch of all four
    kernels' entry points and their size reports."""
    assert 80 in fa.HEAD_DIMS
    csrc = ROOT / "src/repro_torch/kernels/csrc"
    fwd = (csrc / "flash_attention.cu").read_text()
    bwd = (csrc / "flash_attention_bwd.cu").read_text()
    for line in ("case 80: return launch_f32<80>(FA_ARGS, lse_f);",
                 "case 80: return tc::launch<80>(FA_ARGS, lse_f, out_lo);",
                 "case 80: return fa_sizes<80>(dtype, which);",
                 "if constexpr (D == 80) wgmma_m64n80k16_rs(o, a, d);"):
        assert line in fwd, line
    for line in ("case 80: return launch_dq<80>(FB_DQ_ARGS);",
                 "case 80: return launch_dkdv<80>(FB_KV_ARGS);",
                 "case 80: return fb_sizes<80>(kernel, which);"):
        assert line in bwd, line


# ---------------------------------------------------------------------------
# the steps' inputs, and what an encoder refuses
# ---------------------------------------------------------------------------

def test_input_specs_shapes_and_dtypes_are_the_references():
    for arch, shape in (("llama3.2-1b", "train_4k"),
                        ("llama3.2-1b", "decode_32k"), (AUDIO, "train_4k"),
                        (AUDIO, "prefill_32k"), (VLM, "train_4k")):
        got = steps.input_specs(get_arch(arch), INPUT_SHAPES[shape])
        want = ref_steps.input_specs(ref_get_arch(arch), REF_SHAPES[shape])
        assert sorted(got) == sorted(want)
        for key, spec in got.items():
            assert spec.device.type == "meta"
            assert tuple(spec.shape) == tuple(want[key].shape)
            assert str(spec.dtype).removeprefix("torch.") == \
                str(want[key].dtype)
    s = steps.input_specs(get_arch("llama3.2-1b"), INPUT_SHAPES["train_4k"])
    assert tuple(s["tokens"].shape) == (256, 4096)
    s = steps.input_specs(get_arch("llama3.2-1b"),
                          INPUT_SHAPES["decode_32k"])
    assert tuple(s["tokens"].shape) == (128, 1)
    audio = steps.input_specs(get_arch(AUDIO), INPUT_SHAPES["train_4k"])
    assert tuple(audio["frames"].shape) == (256, 4096, 1280)
    assert tuple(audio["labels"].shape) == (256, 4096)
    f32 = steps.input_specs(get_arch(AUDIO), INPUT_SHAPES["train_4k"],
                            TrainConfig(dtype="float32"))
    assert f32["frames"].dtype == torch.float32


def test_encoder_only_raises_where_the_reference_does():
    cfg, ref_cfg = _audio_cfgs(64)
    _, p = _params(64)
    with pytest.raises(ValueError, match="encoder-only"):
        steps.input_specs(get_arch(AUDIO), INPUT_SHAPES["decode_32k"])
    with pytest.raises(ValueError):
        ref_steps.input_specs(ref_get_arch(AUDIO), REF_SHAPES["decode_32k"])
    # init_decode_state builds the caches, as the reference's does;
    # decode_step refuses
    state = init_decode_state(cfg, 2, 8, dtype=torch.float32, device="cpu")
    want = ref_init_decode_state(ref_cfg, 2, 8, dtype=jnp.float32)
    got_leaves, _ = tree_flatten(state["layers"])
    assert [tuple(t.shape) for t in got_leaves] == \
        [w.shape for w in jax.tree_util.tree_leaves(want["layers"])]
    with pytest.raises(ValueError, match="encoder-only"):
        decode_step(cfg, p, state, torch.zeros(2, 1, dtype=torch.long))
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", AUDIO, "--device", "cpu"])


def test_serve_refuses_an_encoder_before_it_needs_a_device(monkeypatch):
    """The encoder's exit comes first, as the reference's: even with no
    CUDA device and no ``--device``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", AUDIO])


# ---------------------------------------------------------------------------
# chameleon-34b: the VLM family (image tokens are vocabulary ids)
# ---------------------------------------------------------------------------

def _vlm():
    cfg, ref_cfg = get_arch(VLM).reduced(), ref_get_arch(VLM).reduced()
    ref_p = ref_init_model(ref_cfg, jax.random.PRNGKey(7), dtype=jnp.float32)
    return cfg, ref_cfg, ref_p, bridge.from_reference(jax.device_get(ref_p),
                                                      "cpu")


@pytest.mark.parametrize("s", [16, 512])
def test_chameleon_forward_matches_reference(s):
    cfg, ref_cfg, ref_p, p = _vlm()
    assert cfg.family == "vlm" and cfg.frontend == "vq_patches"
    toks = np.random.default_rng(s).integers(0, cfg.vocab_size, (1, s))
    got, _ = forward(cfg, p, {"tokens": torch.from_numpy(toks)})
    want, _ = ref_forward(ref_cfg, ref_p, {"tokens": jnp.asarray(toks)})
    _close(got, want, 1e-4)


def test_chameleon_decode_matches_forward_and_reference():
    """Decode step by step equals the forward at every position (as
    ``tests/test_decode_consistency.py`` holds the reference), and each
    step equals the reference's decode step."""
    cfg, ref_cfg, ref_p, p = _vlm()
    b, s = 2, 12
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (b, s))
    full, _ = forward(cfg, p, {"tokens": torch.from_numpy(toks)})
    state = init_decode_state(cfg, b, s, dtype=torch.float32, device="cpu")
    ref_state = ref_init_decode_state(ref_cfg, b, s, dtype=jnp.float32)
    outs = []
    for t in range(s):
        lg, state = decode_step(cfg, p, state,
                                torch.from_numpy(toks[:, t:t + 1]))
        want, ref_state = ref_decode_step(ref_cfg, ref_p, ref_state,
                                          jnp.asarray(toks[:, t:t + 1]))
        _close(lg, want, 1e-4)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the card's audio phases as chip_smoke.py sizes them
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_audio", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_audio_phases_fit_at_full_width_and_depth():
    """hubert-xlarge trains at its full 48 layers on one card: 945 M
    parameters, 16 B each with the gradient and AdamW's two moments
    (15.1 GB); its layer shape is among the D = 80 kernel checks, and
    the kernel checks, SASS reads and backward timings take D = 80."""
    smoke = _chip_smoke()
    cfg = ref_get_arch(AUDIO)
    shapes = jax.eval_shape(lambda: ref_init_model(
        cfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    n = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
    assert round(n / 1e6) == 945
    assert 16 * n < 0.25 * smoke.CARD_BYTES
    b, s = smoke.AUDIO_TRAIN
    assert (b, s) == (2, 1024) and smoke.AUDIO_ENCODE == (8, 1024)
    assert 80 in smoke.HEAD_DIMS
    layer = (b, s, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    assert any(shape == layer and kw == {"causal": False}
               for _, shape, kw in smoke.WIDE_HEAD_CASES)
    assert (AUDIO, (b, s, cfg.n_heads, 80), (b, s, cfg.n_kv_heads, 80), 0,
            False) in smoke.FA_BWD_LAYERS
    assert any(arch == VLM for arch, *_ in smoke.WIDE_PREFILL)
