"""The port's LM training slice (``models/transformer.py: lm_loss`` and
``forward(remat=...)``, ``launch/steps.py: make_train_step``,
``fl/client.py: LMTrainer``, ``launch/train.py``, ``launch/fl_train.py``
with an LM arch) against the JAX package's: reduced ``llama3.2-1b``
(dense, chunked attention), ``hymba-1.5b`` (hybrid, banded attention
with window 64, the SSM scan), ``mixtral-8x7b`` and ``arctic-480b``
(MoE: capacity dispatch, the load-balance loss; arctic's dense
residual) and ``xlstm-350m`` (the mLSTM's chunks, the sLSTM's time loop)
at S=512, parameters made by the
reference's ``init_model`` and carried across with
``bridge.from_reference``, the same numpy tokens on both sides.

Tolerances: the loss 1e-5 (f32 sums over 2 x 511 tokens in another
order); gradients 1e-4 relative to each leaf's largest entry (f32
matmuls and softmax sums in another order through two layers, as the
forward's whole-model tolerance in ``tests/test_torch_transformer.py``);
Adam's moments the same.  A parameter after Adam steps is held to the
step bound of ``tests/test_torch_trainer.py``: Adam's normalized update
turns rounding noise in a near-zero gradient into up to one ``lr`` a
step, so each parameter is within ``steps * lr`` of the reference's,
and their mean difference far below it.  The port against itself
(remat, batched against looped, two seeded runs) is bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as ref_get_arch
from repro.config.base import FLConfig as RefFLConfig
from repro.config.base import TrainConfig as RefTrainConfig
from repro.fl.client import LMTrainer as RefLMTrainer
from repro.launch import steps as ref_steps
from repro.models import init_model as ref_init_model
from repro.models import lm_loss as ref_lm_loss
from repro_torch import bridge
from repro_torch.config import get_arch
from repro_torch.config.base import FLConfig, TrainConfig
from repro_torch.fl.client import LMTrainer, build_fl_clients
from repro_torch.launch import fl_train, steps, train
from repro_torch.models import lm_loss
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

torch.set_num_threads(1)

ARCHS = ["llama3.2-1b", "hymba-1.5b", "mixtral-8x7b", "arctic-480b",
         "xlstm-350m"]
DENSE = ["granite-20b", "nemotron-4-340b", "phi4-mini-3.8b"]
_PARAMS = {}


def _params(arch):
    """(reference params as jax arrays, the port's bridged copy)."""
    if arch not in _PARAMS:
        cfg = ref_get_arch(arch).reduced()
        ref = ref_init_model(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
        _PARAMS[arch] = (ref, bridge.from_reference(jax.device_get(ref),
                                                    "cpu"))
    return _PARAMS[arch]


def _port_copy(arch):
    return bridge.from_reference(jax.device_get(_params(arch)[0]), "cpu")


def _tokens(arch, b, s, seed=0):
    cfg = get_arch(arch).reduced()
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def _grads_close(got_tree, want_tree, rtol=1e-4):
    got = tree_leaves(got_tree)
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.detach().numpy(), w, rtol=rtol,
            atol=rtol * max(1.0, float(np.abs(w).max())))


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_lm_train",
        Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _port_loss_and_grads(cfg, params, tokens, **kw):
    return steps.loss_and_grads(
        lambda p: lm_loss(cfg, p, {"tokens": torch.from_numpy(tokens)}, **kw),
        params)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(arch):
    ref_p, pt_p = _params(arch)
    tokens = _tokens(arch, 2, 512)
    cfg = get_arch(arch).reduced()
    (ref_loss, ref_aux), ref_g = jax.value_and_grad(
        lambda p: ref_lm_loss(ref_get_arch(arch).reduced(), p,
                              {"tokens": jnp.asarray(tokens)}),
        has_aux=True)(ref_p)
    loss, aux, grads = _port_loss_and_grads(cfg, pt_p, tokens)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    # the MoE layers' load-balance losses (0.01 of them in the loss); 0
    # for the other families
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5)
    assert (float(aux) == 0.0) == (cfg.family != "moe")
    _grads_close(grads, ref_g)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_configs_lm_loss_and_grads_match_reference(arch):
    """The dense configs copied in this slice (gelu, squared-ReLU and
    SwiGLU MLPs), reduced, at S=128."""
    ref_cfg = ref_get_arch(arch).reduced()
    ref_p = ref_init_model(ref_cfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    pt_p = bridge.from_reference(jax.device_get(ref_p), "cpu")
    tokens = _tokens(arch, 2, 128, seed=1)
    (ref_loss, _), ref_g = jax.value_and_grad(
        lambda p: ref_lm_loss(ref_cfg, p, {"tokens": jnp.asarray(tokens)}),
        has_aux=True)(ref_p)
    loss, _, grads = _port_loss_and_grads(get_arch(arch).reduced(), pt_p,
                                          tokens)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    _grads_close(grads, ref_g)


def test_lm_loss_chunks_match_one_chunk():
    """``loss_chunk`` splits the shifted sequence (S-1 = 128 = 4 x 32)
    into checkpointed chunks: the same loss and gradients as one chunk,
    to f32 summation order."""
    arch = "llama3.2-1b"
    cfg = get_arch(arch).reduced()
    tokens = _tokens(arch, 2, 129, seed=2)
    pt_p = _params(arch)[1]
    one = _port_loss_and_grads(cfg, pt_p, tokens, loss_chunk=512)
    four = _port_loss_and_grads(cfg, pt_p, tokens, loss_chunk=32)
    np.testing.assert_allclose(float(four[0]), float(one[0]), rtol=1e-6)
    for a, b in zip(tree_leaves(four[2]), tree_leaves(one[2])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_are_bit_identical(arch):
    """remat off, ``"full"`` and ``"dots"``: the same loss and gradients
    bit for bit (recomputation repeats the same operations)."""
    _, pt_p = _params(arch)
    cfg = get_arch(arch).reduced()
    tokens = _tokens(arch, 1, 512, seed=3)
    base = _port_loss_and_grads(cfg, pt_p, tokens)
    for policy in ("full", "dots"):
        got = _port_loss_and_grads(cfg, pt_p, tokens, remat=True,
                                   remat_policy=policy)
        assert torch.equal(got[0], base[0])
        for a, b in zip(tree_leaves(got[2]), tree_leaves(base[2])):
            assert torch.equal(a, b), policy


def test_dots_policy_saves_the_matrix_products_only():
    """Under ``"dots"`` the recomputed backward reruns no ``mm`` (its
    outputs were kept) but does rerun the rest; under ``"full"`` it
    reruns the ``mm``s too."""
    from torch.utils._python_dispatch import TorchDispatchMode
    arch = "llama3.2-1b"
    cfg = get_arch(arch).reduced()
    tokens = torch.from_numpy(_tokens(arch, 1, 64, seed=4))

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default):
                self.mm += 1
            return func(*args, **(kwargs or {}))

    def backward_mms(**kw):
        leaves, treedef = tree_flatten(_params(arch)[1])
        leaves = [l.detach().requires_grad_(True) for l in leaves]
        loss, _ = lm_loss(cfg, tree_unflatten(treedef, leaves),
                          {"tokens": tokens}, **kw)
        with Count() as c:
            torch.autograd.grad(loss, leaves)
        return c.mm

    none = backward_mms()
    full = backward_mms(remat=True, remat_policy="full")
    dots = backward_mms(remat=True, remat_policy="dots")
    # a block's weight products (q, k, v, o, gate, up, down) rerun; the
    # down projection's output is saved by nothing, so a recompute that
    # stops early may skip it
    assert full >= none + 6 * cfg.num_layers
    assert dots == none


def _tcfg():
    return dict(dtype="float32", remat=False, attn_chunk_q=128,
                attn_chunk_kv=128)


@pytest.mark.parametrize("arch", ARCHS)
def test_make_train_step_matches_reference(arch):
    """One AdamW step with global-norm clip 1.0: loss, grad norm and
    the moments tight; parameters within one ``lr`` (the step bound)."""
    ref_p, _ = _params(arch)
    pt_p = _port_copy(arch)
    tokens = _tokens(arch, 2, 512, seed=5)
    ref_cfg = ref_get_arch(arch).reduced()
    ref_step, ref_opt = ref_steps.make_train_step(ref_cfg,
                                                  RefTrainConfig(**_tcfg()))
    ref_new, ref_state, ref_m = ref_step(ref_p, ref_opt.init(ref_p),
                                         {"tokens": jnp.asarray(tokens)})
    step, opt = steps.make_train_step(get_arch(arch).reduced(),
                                      TrainConfig(**_tcfg()))
    state = opt.init(pt_p)
    new, state, m = step(pt_p, state, {"tokens": torch.from_numpy(tokens)})
    assert new is pt_p                      # updated in place
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(ref_m["grad_norm"]), rtol=1e-4)
    assert int(state["t"]) == int(ref_state["t"]) == 1
    _grads_close(state["m"], ref_state["m"])
    _grads_close(state["v"], ref_state["v"], rtol=2e-4)
    lr = TrainConfig().lr
    diffs = [np.abs(a.numpy() - np.asarray(b)) for a, b in
             zip(tree_leaves(new), jax.tree_util.tree_leaves(ref_new))]
    assert max(float(d.max()) for d in diffs) <= lr * 1.001
    assert float(np.mean(np.concatenate([d.ravel() for d in diffs]))) \
        < 0.05 * lr


def test_train_step_in_place_equals_functional_update():
    """The in-place, leaf-by-leaf update is the optimizer's functional
    update (``clip_by_global_norm``, ``opt.update``, ``apply_updates``
    on the whole tree) bit for bit."""
    from repro_torch.optim import clip_by_global_norm
    from repro_torch.optim.optimizer import apply_updates
    arch = "hymba-1.5b"
    cfg = get_arch(arch).reduced()
    tcfg = TrainConfig(**_tcfg())
    tokens = torch.from_numpy(_tokens(arch, 1, 128, seed=6))
    step, opt = steps.make_train_step(cfg, tcfg)
    p0 = _port_copy(arch)
    state0 = opt.init(p0)
    for _ in range(2):                      # the second step has t = 1
        _, _, grads = steps.loss_and_grads(
            lambda p: lm_loss(cfg, p, {"tokens": tokens}, chunk_q=128,
                              chunk_kv=128), p0)
        grads, _ = clip_by_global_norm(grads, tcfg.grad_clip)
        ups, state1 = opt.update(grads, state0, p0, tcfg.lr)
        p1 = apply_updates(p0, ups)
        p_in = tree_unflatten(tree_flatten(p0)[1],
                              [l.clone() for l in tree_leaves(p0)])
        s_in = tree_unflatten(tree_flatten(state0)[1],
                              [l.clone() for l in tree_leaves(state0)])
        p2, s2, _ = step(p_in, s_in, {"tokens": tokens})
        for a, b in zip(tree_leaves(p2) + tree_leaves(s2),
                        tree_leaves(p1) + tree_leaves(state1)):
            assert torch.equal(a, b)
        p0, state0 = p1, state1


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "arctic-480b"])
def test_moe_train_steps_repeat_bit_for_bit(arch, monkeypatch):
    """Two seeded runs of two AdamW steps of an MoE config give equal
    losses, aux losses, gradient norms, parameters and moments, bit for
    bit.  At capacity factor 1 the dispatch's gathers have repeated
    indices of both kinds -- the clamped source of an empty slot and
    the clamped slot of a dropped token choice -- and their backward
    sums over the repeats."""
    import dataclasses
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_arch(arch).reduced(),
                              moe_capacity_factor=1.0)
    tokens = torch.from_numpy(_tokens(arch, 2, 128, seed=8))
    routes = []
    real_route = moe._route_group

    def recording(*args):
        out = real_route(*args)
        routes.append((out[1], out[3]))         # slot_valid, tok_keep
        return out

    monkeypatch.setattr(moe, "_route_group", recording)

    def run():
        step, opt = steps.make_train_step(cfg, TrainConfig(**_tcfg()))
        params = _port_copy(arch)
        state = opt.init(params)
        metrics = []
        for _ in range(2):
            params, state, m = step(params, state, {"tokens": tokens})
            metrics += [m[k].clone() for k in ("loss", "aux", "grad_norm")]
        return metrics + tree_leaves(params) + tree_leaves(state)

    first, second = run(), run()
    assert len(first) == len(second)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert any(not bool(valid.all()) for valid, _ in routes)
    assert any(not bool(keep.all()) for _, keep in routes)


@pytest.mark.parametrize("name", ["adamw", "adam", "momentum", "sgd"])
@pytest.mark.parametrize("chunk,scale", [(steps.UPDATE_CHUNK, None),
                                         (5, 0.75)])
def test_update_in_place_is_the_optimizer_bit_for_bit(name, chunk, scale,
                                                      monkeypatch):
    """``update_in_place`` (the train steps' leaf-by-leaf update) equals
    ``opt.update`` + ``apply_updates`` on the whole tree, two steps, for
    every optimizer an LM trainer can be given; also with each leaf
    updated 5 elements at a time (a leaf of 12 in pieces of 5, 5 and 2,
    one of 5 whole) and the gradients scaled first, as the clip does."""
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.optimizer import apply_updates
    opt = make_optimizer(name)
    rng = np.random.default_rng(7)
    monkeypatch.setattr(steps, "UPDATE_CHUNK", chunk)

    def tree():
        return {"a": torch.from_numpy(rng.standard_normal((3, 4))
                                      .astype(np.float32)),
                "b": {"c": torch.from_numpy(rng.standard_normal(5)
                                            .astype(np.float32))}}

    params = tree()
    state = opt.init(params)
    p_in = tree_unflatten(tree_flatten(params)[1],
                          [l.clone() for l in tree_leaves(params)])
    s_in = tree_unflatten(tree_flatten(state)[1],
                          [l.clone() for l in tree_leaves(state)])
    for _ in range(2):
        grads = tree()
        g_scale = None if scale is None else torch.tensor(scale)
        scaled = grads if scale is None else tree_unflatten(
            tree_flatten(grads)[1], [(g.float() * g_scale).to(g.dtype)
                                     for g in tree_leaves(grads)])
        ups, state = opt.update(scaled, state, params, 1e-2)
        params = apply_updates(params, ups)
        p_in, s_in = steps.update_in_place(opt, p_in, s_in, grads, 1e-2,
                                           g_scale)
        for a, b in zip(tree_leaves(p_in) + tree_leaves(s_in),
                        tree_leaves(params) + tree_leaves(state)):
            assert torch.equal(a, b)


def _lm_trainers(arch, n_clients=3, local_epochs=2):
    kw = dict(n_clients=n_clients, n_tiers=2, tau=2, rounds=1, seed=0,
              local_epochs=local_epochs)
    ref_cfg = ref_get_arch(arch).reduced()
    ref = RefLMTrainer(ref_cfg, RefFLConfig(**kw), corpus_tokens=40_000)
    port = LMTrainer(get_arch(arch).reduced(), FLConfig(**kw),
                     corpus_tokens=40_000, device="cpu")
    return ref, port


def _within_step_bound(got, want, steps_, lr):
    diffs = [np.abs(a.numpy() - np.asarray(b)) for a, b in
             zip(tree_leaves(got), jax.tree_util.tree_leaves(want))]
    assert max(float(d.max()) for d in diffs) <= steps_ * lr * 1.001
    assert float(np.mean(np.concatenate([d.ravel() for d in diffs]))) \
        < 0.05 * lr


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_trainer_matches_reference(arch):
    """``local_train``, ``local_train_batch`` and ``local_train_cohort``
    from bridged parameters: the same data streams (client sizes, the
    batches of every seed), models within the Adam step bound."""
    ref, port = _lm_trainers(arch)
    for a, b in zip(ref.client_toks, port.client_toks):
        assert a.tobytes() == b.tobytes()
    assert ref._batch(ref.test_toks, 1234).tobytes() == \
        port._batch(port.test_toks, 1234).tobytes()
    ref_p = ref.init_params(0)
    pt_p = bridge.from_reference(jax.device_get(ref_p), "cpu")
    lr, ep = port.fl.lr, port.fl.local_epochs
    out_ref, n_ref = ref.local_train(ref_p, 1, rnd_seed=3)
    out_pt, n_pt = port.local_train(pt_p, 1, rnd_seed=3)
    assert n_ref == n_pt
    _within_step_bound(out_pt, out_ref, ep, lr)
    # the start model is not touched by the in-place steps
    for a, b in zip(tree_leaves(pt_p), jax.tree_util.tree_leaves(ref_p)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    ids = [0, 2]
    st_ref, sz_ref = ref.local_train_batch(ref_p, ids, 4)
    st_pt, sz_pt = port.local_train_batch(pt_p, ids, 4)
    np.testing.assert_array_equal(sz_pt, sz_ref)
    _within_step_bound(st_pt, st_ref, ep, lr)
    starts_ref = jax.tree_util.tree_map(lambda l: jnp.stack([l, l * 0.5]),
                                        ref_p)
    starts_pt = bridge.from_reference(jax.device_get(starts_ref), "cpu")
    co_ref, _ = ref.local_train_cohort(starts_ref, [1, 2], [5, 6])
    co_pt, _ = port.local_train_cohort(starts_pt, [1, 2], [5, 6])
    _within_step_bound(co_pt, co_ref, ep, lr)
    np.testing.assert_allclose(port.evaluate(out_pt), ref.evaluate(out_ref),
                               atol=0.02)


def test_lm_trainer_batched_paths_equal_looped_in_port():
    """Batched and cohort paths are the looped ``local_train`` bit for
    bit; a repeated (padding) client trains once and fills both rows."""
    _, port = _lm_trainers("hymba-1.5b", local_epochs=1)
    params = port.init_params(0)
    ids = [0, 2, 2]
    stacked, sizes = port.local_train_batch(params, ids, rnd_seed=2)
    np.testing.assert_array_equal(
        sizes, np.asarray([len(port.client_toks[c]) for c in ids],
                          np.float32))
    for pos, c in enumerate(ids):
        one, _ = port.local_train(params, c, rnd_seed=2)
        for a, b in zip(tree_leaves(stacked), tree_leaves(one)):
            assert torch.equal(a[pos], b)
    starts = [port.init_params(s) for s in (0, 1)]
    stacked_starts = jax.tree_util.tree_map(lambda *x: torch.stack(x),
                                            *starts)
    cohort, _ = port.local_train_cohort(stacked_starts, [1, 0], [4, 5])
    for pos, (c, s) in enumerate([(1, 4), (0, 5)]):
        one, _ = port.local_train(starts[pos], c, rnd_seed=s)
        for a, b in zip(tree_leaves(cohort), tree_leaves(one)):
            assert torch.equal(a[pos], b)


def test_lm_trainer_custom_step_uses_the_looped_path():
    cfg = get_arch("llama3.2-1b").reduced()
    port = LMTrainer(cfg, FLConfig(n_clients=2), corpus_tokens=20_000,
                     step_fn=lambda p, o, t: (p, o, None), device="cpu")
    params = port.init_params(0)
    with pytest.raises(NotImplementedError, match="looped"):
        port.local_train_batch(params, [0], 1)
    out, _ = port.local_train(params, 0, 1)
    for a, b in zip(tree_leaves(out), tree_leaves(params)):
        assert torch.equal(a, b)


def test_build_fl_clients_builds_reduced_lm_trainers():
    fl = FLConfig(n_clients=2)
    tr = build_fl_clients("hymba-1.5b", fl, device="cpu")
    assert isinstance(tr, LMTrainer)
    assert tr.cfg == get_arch("hymba-1.5b").reduced()
    full = build_fl_clients("llama3.2-1b", fl, reduced=False, device="cpu")
    assert full.cfg == get_arch("llama3.2-1b")


def test_fl_train_default_arch_is_llama_and_runs_on_the_cpu(capsys):
    hist = fl_train.main(["--rounds", "2", "--clients", "4", "--tiers",
                          "2", "--tau", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[fl_train] feddct on llama3.2-1b" in out
    assert len(hist.accuracy) == 2
    again = fl_train.main(["--rounds", "2", "--clients", "4", "--tiers",
                           "2", "--tau", "1", "--device", "cpu"])
    assert again.to_json() == hist.to_json()


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    losses = train.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                         "--log-every", "1", "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "[train] llama3.2-1b-reduced:" in out
    assert out.count("[train] step") == 3
    assert "[train] checkpoint saved to" in out
    assert f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f}" in out
    from repro_torch.checkpoint import latest_step
    assert latest_step(str(tmp_path)) == 3
    # seeded: a second run gives the same losses
    assert train.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                       "--log-every", "5"]) == losses


def test_train_cli_corpus_call_is_the_one_chip_smoke_prefetches(
        monkeypatch):
    """chip_smoke.py makes ``launch.train``'s corpus ahead, in worker
    processes, keyed by the call the CLI makes: the vocabulary,
    ``TRAIN_CORPUS_TOKENS`` tokens and seed 0."""
    smoke = _chip_smoke()
    calls = []
    real = train.make_token_dataset

    def recording(*args, **kw):
        calls.append((args, kw))
        return real(args[0], 5_000, seed=kw["seed"])

    monkeypatch.setattr(train, "make_token_dataset", recording)
    train.main(["--device", "cpu", "--steps", "1", "--batch", "1",
                "--seq", "16"])
    vocab = get_arch("llama3.2-1b").reduced().vocab_size
    assert calls == [((vocab, smoke.TRAIN_CORPUS_TOKENS), {"seed": 0})]


def test_train_cli_mesh_and_device_rules(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_FLAGS", raising=False)
    argv = ["--device", "cpu", "--steps", "1", "--batch", "1", "--seq",
            "16"]
    # a mesh of more points than devices raises, as jax.make_mesh does;
    # (1, 1) fits the one device and trains as without it
    with pytest.raises(ValueError, match="needs 4 devices"):
        train.main(argv + ["--mesh", "2,2"])
    assert train.main(argv + ["--mesh", "1,1"]) == train.main(argv)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(["--steps", "1"])


def test_training_leaves_no_tensor_in_reference_cycles():
    """A train run frees its tensors by reference counting alone: no
    tensor is left in a reference cycle for the cyclic collector (a
    self-recursive closure in ``tree.py`` once kept every flattened
    tree's leaves -- at full width, gigabytes of gradients -- alive
    until it ran)."""
    import gc
    gc.collect()
    gc.disable()
    try:
        train.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                    "--arch", "hymba-1.5b", "--log-every", "5"])
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        held = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert held == []


def test_chip_smoke_train_cuts_fit_and_keep_pairs():
    """The card's train runs as chip_smoke.py cuts them: mixtral-8x7b at
    MOE_TRAIN_LAYERS is 3,164.7 M parameters, 16 B each (parameter,
    gradient, AdamW's two moments) 50.6 GB, under the card's 80 GB with
    room for activations, where one layer more (73.9 GB) is not; the
    xLSTM depth cuts are whole (mLSTM, sLSTM) pairs."""
    import dataclasses
    smoke = _chip_smoke()

    def n_params(arch, layers):
        cfg = dataclasses.replace(ref_get_arch(arch), num_layers=layers)
        shapes = jax.eval_shape(lambda: ref_init_model(
            cfg, jax.random.PRNGKey(0), dtype=jnp.float32))
        return sum(int(np.prod(a.shape))
                   for a in jax.tree_util.tree_leaves(shapes))

    arch, b, s = smoke.MOE_TRAIN
    n = n_params(arch, smoke.MOE_TRAIN_LAYERS)
    assert round(n / 1e5) == 31647
    assert round(16 * n / 1e8) == 506 and 16 * n < 0.65 * smoke.CARD_BYTES
    assert 16 * n_params(arch, smoke.MOE_TRAIN_LAYERS + 1) > \
        0.9 * smoke.CARD_BYTES
    # one MoE group of b * s tokens: the train config's group size does
    # not divide it
    assert (b * s) % TrainConfig().moe_group_tokens
    for layers in (smoke.XLSTM_TRAIN_LAYERS, smoke.XLSTM_CONSISTENCY_LAYERS,
                   smoke.XLSTM_SERVE_LAYERS):
        assert layers % 2 == 0 and layers >= 4
    assert smoke.XLSTM_CONSISTENCY_S % 256 == 0 \
        and smoke.XLSTM_CONSISTENCY_S > 256
    assert all(x % 256 == 0 for x in (smoke.XLSTM_PREFILL[1],
                                      smoke.XLSTM_TRAIN[1]))


def test_chip_smoke_profile_readings():
    """``union_s`` (the card's busy time) merges overlapping kernel
    intervals; ``MOE_STEP_GROUPS`` puts the dispatch's sorts, searches,
    gathers and index backward apart from the GEMMs, K4 and the other
    elementwise kernels, and changes no other group's names."""
    smoke = _chip_smoke()
    assert smoke.union_s([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert smoke.union_s([]) == 0
    groups = smoke.MOE_STEP_GROUPS
    for name, want in (
            ("void at::native::index_elementwise_kernel<128, 4>", "dispatch"),
            ("void at::native::indexing_backward_kernel<float>", "dispatch"),
            ("DeviceRadixSortOnesweepKernel", "dispatch"),
            ("void at::native::searchsorted_cuda_kernel<long>", "dispatch"),
            ("void at::native::_scatter_gather_elementwise_kernel",
             "dispatch"),
            ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n", "gemm"),
            ("void fa_bwd_dq_kernel<128>", "k4_dq"),
            ("void fa_fwd_f32_kernel<128, true>", "k4_fwd"),
            ("void at::native::vectorized_elementwise_kernel<4>",
             "elementwise")):
        assert smoke.step_group(name, groups) == want, name
    assert {g for g, _ in smoke.STEP_GROUPS} | {"dispatch"} == \
        {g for g, _ in groups}
    assert smoke.step_group("DeviceRadixSortOnesweepKernel") == "other"


class _Event:
    """A stand-in for the profiler's raw (kineto) event."""

    def __init__(self, kind, name, start, end, corr=0, tid=1, shapes=(),
                 device="cpu"):
        from torch.autograd import DeviceType
        self._v = (kind, name, start, end, corr, tid, list(shapes),
                   DeviceType.CUDA if device == "cuda" else DeviceType.CPU)

    def name(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def shapes(self):
        return self._v[6]

    def device_type(self):
        return self._v[7]

    def is_user_annotation(self):
        return self._v[0] in ("user_annotation", "gpu_user_annotation")


def test_chip_smoke_step_profile_reads_raw_events():
    """``step_profile`` on raw profiler events: each kernel goes to the
    innermost op around its launch on the launch's thread (ops nest),
    kernels launched inside the optimizer range are "optimizer", the
    device-side span of that range is not a kernel, busy time is the
    union of the kernel intervals."""
    from types import SimpleNamespace
    smoke = _chip_smoke()
    ev = [
        # thread 1: matmul > mm launches a GEMM (corr 10); add (corr 11)
        _Event("cpu_op", "aten::matmul", 0, 100, 1, shapes=[[2, 3]]),
        _Event("cpu_op", "aten::mm", 10, 90, 2, shapes=[[2, 3], [3, 4]]),
        _Event("cuda_runtime", "cudaLaunchKernel", 20, 25, 10),
        _Event("cpu_op", "aten::add", 110, 150, 3, shapes=[[4]]),
        _Event("cuda_runtime", "cudaLaunchKernel", 120, 125, 11),
        # thread 2 (the backward's): bmm launches corr 12 at t = 50,
        # inside thread 1's mm, which must not claim it
        _Event("cpu_op", "aten::bmm", 40, 60, 4, tid=2, shapes=[[8]]),
        _Event("cuda_runtime", "cudaLaunchKernel", 50, 52, 12, tid=2),
        # the optimizer range and an elementwise kernel inside it
        _Event("user_annotation", "optimizer", 200, 300, 5),
        _Event("cpu_op", "aten::mul", 210, 240, 6, shapes=[[4], []]),
        _Event("cuda_runtime", "cudaLaunchKernel", 220, 221, 13),
        _Event("gpu_user_annotation", "optimizer", 1000, 5000, 14,
               device="cuda"),
        _Event("kernel", "sm90_xmma_gemm_f32", 1000, 1400, 10,
               device="cuda"),
        _Event("kernel", "vectorized_elementwise_kernel add", 1300, 1500,
               11, device="cuda"),
        _Event("kernel", "cutlass_sgemm batched", 2000, 2300, 12,
               device="cuda"),
        _Event("kernel", "vectorized_elementwise_kernel mul", 3000, 3100,
               13, device="cuda"),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: ev)))
    got = smoke.step_profile(prof, 1.0)
    assert got["kernels"] == 4 and got["optimizer_ranges"] == 1
    assert got["device_s"] == pytest.approx(1000e-9)
    assert got["busy_s"] == pytest.approx(900e-9)          # 1000..1500 etc.
    g = got["groups_s"]
    assert g["gemm"] == pytest.approx(700e-9)
    assert g["elementwise"] == pytest.approx(200e-9)
    assert g["optimizer"] == pytest.approx(100e-9)
    assert got["op_s"] == pytest.approx({"aten::mm": 400e-9,
                                         "aten::bmm": 300e-9,
                                         "aten::add": 200e-9,
                                         "aten::mul": 100e-9})
    assert got["top_ops"][0] == {"op": "aten::mm",
                                 "shapes": "[[2, 3], [3, 4]]", "calls": 1,
                                 "s": pytest.approx(400e-9)}
