"""The port's LM mesh against the JAX package's: the mesh factories
(``launch/mesh.py``), the abstract trees (``launch/steps.py:
abstract_*``), context-parallel attention (``models/attention.py:
chunked_attention_cp``, ``banded_attention_cp`` and the dispatch), the
model under a mesh, ``LMTrainer`` on a client mesh and ``launch.train
--mesh``.

The reference runs on one CPU device, so where it must see a model axis
its attention module's ``axis_size`` is replaced for the test (its
``hint`` is the identity with no mesh set); the port sees the same axis
through a real ``set_mesh`` over virtual CPU shards.  Tolerances: 2e-5
for the attention functions (f32 softmax sums in another order, as
``tests/test_torch_attention.py``), 1e-4 for whole-model logits (as
``tests/test_torch_transformer.py``), the client mesh's atol 5e-3 on
accuracies (as ``tests/test_torch_distributed.py``).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as ref_get_arch
from repro.config.base import INPUT_SHAPES as REF_SHAPES
from repro.launch import steps as ref_steps
from repro.models import attention as ref_attn
from repro.models import forward as ref_forward
from repro.models import init_model as ref_init_model
from repro_torch import bridge
from repro_torch.config import get_arch
from repro_torch.config.base import INPUT_SHAPES, FLConfig
from repro_torch.distributed.engine import shard_cohort_train
from repro_torch.distributed.hostdevices import ENV_VAR
from repro_torch.distributed.mesh import make_client_mesh, make_mesh
from repro_torch.fl.client import LMTrainer
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch import dryrun, fl_train, steps, train
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import (decode_step, forward, init_decode_state,
                                init_model)
from repro_torch.models import attention as attn
from repro_torch.sharding.hints import hint_spec, set_mesh
from repro_torch.tree import tree_flatten, tree_leaves

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_forced_shards(monkeypatch):
    monkeypatch.delenv(ENV_VAR, raising=False)
    yield
    set_mesh(None)


def cpu_mesh(data, model):
    return make_mesh((data, model), ("data", "model"),
                     devices=["cpu"] * (data * model))


def _qkv(seed, b, s, h, d, t, hkv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, t, hkv, d)).astype(np.float32),
            rng.standard_normal((b, t, hkv, d)).astype(np.float32))


# ---------------------------------------------------------------------------
# mesh factories
# ---------------------------------------------------------------------------

def test_mesh_factories(monkeypatch):
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.axis_names == ("data", "model")
    assert single.devices.shape == (16, 16)
    assert multi.axis_names == ("pod", "data", "model")
    assert multi.devices.shape == (2, 16, 16)
    assert {d.type for d in multi.devices.flat} == {"meta"}
    # the host mesh clamps to the devices there are, as the reference's
    assert make_host_mesh(data=2, model=4, device="cpu").devices.shape \
        == (1, 1)
    monkeypatch.setenv(ENV_VAR, "--force_client_shards=4")
    host = make_host_mesh(data=2, model=4, device="cpu")
    assert host.devices.shape == (2, 2)
    assert host.shape == {"data": 2, "model": 2}
    assert make_host_mesh(model=4, device="cpu").devices.shape == (1, 4)
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="axis names"):
        make_mesh((1, 4), ("model",), devices=["cpu"] * 4)


# ---------------------------------------------------------------------------
# abstract trees
# ---------------------------------------------------------------------------

def _same_abstract(port, ref):
    leaves, _ = tree_flatten(port)
    ref_leaves = jax.tree_util.tree_leaves(ref)
    assert len(leaves) == len(ref_leaves)
    for a, b in zip(leaves, ref_leaves):
        assert a.is_meta
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)


@pytest.mark.parametrize("arch", dryrun.ASSIGNED)
def test_abstract_trees_match_reference(arch):
    cfg, ref_cfg = get_arch(arch), ref_get_arch(arch)
    _same_abstract(steps.abstract_params(cfg),
                   ref_steps.abstract_params(ref_cfg))
    _same_abstract(steps.abstract_opt_state(cfg),
                   ref_steps.abstract_opt_state(ref_cfg))
    for name, shape in INPUT_SHAPES.items():
        if shape.kind == "decode" and not cfg.is_encoder_only:
            _same_abstract(
                steps.abstract_decode_state(cfg, shape),
                ref_steps.abstract_decode_state(ref_cfg, REF_SHAPES[name]))


def test_abstract_trees_of_the_largest_archs_take_seconds():
    for arch in ("nemotron-4-340b", "arctic-480b"):
        t0 = time.perf_counter()
        n = sum(x.numel() for x in tree_leaves(
            steps.abstract_opt_state(get_arch(arch))["m"]))
        assert time.perf_counter() - t0 < 10
        assert n > 3e11


def test_init_model_draws_the_same_numbers_on_a_real_device():
    cfg = get_arch("hymba-1.5b").reduced()
    a = init_model(cfg, torch.Generator().manual_seed(3))
    b = init_model(cfg, torch.Generator().manual_seed(3), device="cpu")
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# context-parallel attention
# ---------------------------------------------------------------------------

CP_CASES = [  # (b, s, t, h, hkv, d, causal, window, q_offset, cq, ckv)
    (1, 512, 512, 4, 4, 16, True, 0, 0, 128, 128),
    (2, 256, 512, 5, 1, 16, False, 0, 256, 64, 128),
    (1, 512, 512, 8, 2, 16, True, 64, 0, 128, 128),
    (1, 512, 768, 4, 1, 16, True, 200, 256, 128, 256),
    (1, 512, 512, 5, 5, 16, False, 200, 0, 128, 128),
    (1, 384, 512, 4, 4, 16, False, 64, 128, 128, 128),
]


@pytest.mark.parametrize("case", CP_CASES)
def test_cp_attention_plain_versions_match_reference(case):
    b, s, t, h, hkv, d, causal, window, q_offset, cq, ckv = case
    q, k, v = _qkv(sum(case), b, s, h, d, t, hkv)
    kw = dict(causal=causal, window=window, q_offset=q_offset, chunk_q=cq,
              chunk_kv=ckv)
    rep = h // hkv
    ref_in = (jnp.asarray(q), jnp.asarray(np.repeat(k, rep, axis=2)),
              jnp.asarray(np.repeat(v, rep, axis=2)))
    names = ["chunked_attention_cp"] + (["banded_attention_cp"] if window
                                        else [])
    for name in names:
        got = getattr(attn, name)(*(torch.from_numpy(x) for x in (q, k, v)),
                                  **kw)
        want = getattr(ref_attn, name)(*ref_in, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)


DISPATCH = [  # (s, t, h, window, axis size, mode)
    (512, 512, 4, 0, 4, "always"), (512, 512, 4, 0, 4, "auto"),
    (512, 512, 6, 0, 4, "auto"), (512, 512, 6, 0, 4, "never"),
    (512, 512, 6, 64, 4, "auto"), (512, 512, 6, 200, 4, "auto"),
    (512, 512, 4, 200, 4, "always"), (1024, 1024, 6, 0, 16, "auto"),
    (384, 384, 6, 0, 4, "auto"), (512, 512, 4, 0, 1, "always"),
    (512, 512, 4, 64, 1, "always"), (128, 128, 6, 0, 4, "always"),
    (512, 1024, 5, 128, 8, "auto"),
]


@pytest.mark.parametrize("s,t,h,window,msize,mode", DISPATCH)
def test_dispatch_picks_the_reference_branch(s, t, h, window, msize, mode,
                                             monkeypatch):
    branches = ("naive_attention", "chunked_attention", "banded_attention",
                "chunked_attention_cp", "banded_attention_cp")
    seen = {"port": [], "ref": []}
    for side, mod in (("port", attn), ("ref", ref_attn)):
        monkeypatch.setattr(mod, "axis_size",
                            lambda n, m=msize: m if n == "model" else 1)
        for name in branches:
            real = getattr(mod, name)
            monkeypatch.setattr(mod, name,
                                lambda *a, _n=name, _r=real, _s=side, **kw:
                                (seen[_s].append(_n), _r(*a, **kw))[1])
    q, k, v = _qkv(s + h + window, 1, s, h, 8, t, h)
    kw = dict(causal=True, window=window, chunk_q=128, chunk_kv=128,
              context_parallel=mode)
    got = attn.attention(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    want = ref_attn.attention(*(jnp.asarray(x) for x in (q, k, v)), **kw)
    assert seen["port"] == seen["ref"] and len(seen["port"]) == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("mesh_model,window", [(4, 0), (4, 64), (1, 0)])
def test_cp_on_the_card_is_one_kernel_launch_per_model_shard(
        mesh_model, window, monkeypatch):
    """Routed as on a CUDA tensor: shard r of the model axis hands the
    kernel its q rows at q_offset + r*S/m and the un-repeated k/v; the
    output and the gradients (dk, dv summed over the shards by
    autograd) equal the plain branch's."""
    calls = []

    def recording(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw))
        return fa.flash_attention(q, k, v, **kw)

    q, k, v = (torch.from_numpy(x) for x in
               _qkv(11 + window, 2, 512, 8, 16, 640, 2))
    kw = dict(causal=True, window=window, chunk_q=128, chunk_kv=128,
              q_offset=128)
    name = "banded_attention_cp" if window else "chunked_attention_cp"
    w = torch.randn(2, 512, 8, 16,
                    generator=torch.Generator().manual_seed(1))

    def grads(fn):
        ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*ins, **kw)
        return [out] + list(torch.autograd.grad((out * w).sum(), ins))

    want = grads(getattr(attn, name))                 # the plain branch
    set_mesh(cpu_mesh(1, mesh_model))
    monkeypatch.setattr(attn, "_kernel_route", lambda q, softcap: True)
    monkeypatch.setattr(kernel_ops, "gqa_flash_attention", recording)
    got = grads(getattr(attn, name))
    rows = 512 // mesh_model
    assert calls == [((2, rows, 8, 16), (2, 640, 2, 16),
                      dict(causal=True, window=window,
                           q_offset=128 + r * rows))
                     for r in range(mesh_model)]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_cp_on_the_card_refuses_what_the_kernel_cannot_do(monkeypatch):
    monkeypatch.setattr(attn, "_kernel_route", lambda q, softcap: True)
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 1, 512, 4, 16, 512, 4))
    with pytest.raises(NotImplementedError, match="non-causal"):
        attn.banded_attention_cp(q, k, v, window=64, causal=False)
    set_mesh(cpu_mesh(1, 3))
    with pytest.raises(ValueError, match="split"):
        attn.chunked_attention_cp(q, k, v)


# ---------------------------------------------------------------------------
# the model under a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,route", [("llama3.2-1b", "chunked_cp"),
                                        ("hymba-1.5b", "banded_cp")])
def test_forward_under_a_mesh_matches_reference(arch, route, monkeypatch):
    """The reduced model's forward with ``context_parallel="always"``
    under a (1, 4) CPU mesh against the reference's with a 4-way model
    axis, the same bridged parameters and tokens."""
    cfg = get_arch(arch).reduced()
    ref = ref_init_model(ref_get_arch(arch).reduced(), jax.random.PRNGKey(0),
                         dtype=jnp.float32)
    params = bridge.from_reference(jax.device_get(ref), "cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 384))
    kw = dict(chunk_q=96, chunk_kv=96, context_parallel="always")
    monkeypatch.setattr(ref_attn, "axis_size",
                        lambda n: 4 if n == "model" else 1)
    want, _ = ref_forward(ref_get_arch(arch).reduced(), ref,
                          {"tokens": jnp.asarray(toks)}, **kw)
    routes = []
    real = getattr(attn, route.replace("_cp", "_attention_cp"))
    monkeypatch.setattr(attn, real.__name__,
                        lambda *a, **k: (routes.append(route),
                                         real(*a, **k))[1])
    set_mesh(cpu_mesh(1, 4))
    with torch.no_grad():
        got, _ = forward(cfg, params, {"tokens": torch.from_numpy(toks)},
                         **kw)
    assert routes == [route] * cfg.num_layers
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("model", [4, 8])
def test_decode_step_under_a_mesh_equals_without(model):
    """(1, 4): heads divide the axis; (1, 8): they do not, and head_dim
    does, so decode takes the head-dim hints.  The hints place; the
    values are the same bits."""
    cfg = get_arch("llama3.2-1b").reduced()
    params = init_model(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 6)))

    def run():
        st = init_decode_state(cfg, 2, 8, dtype=torch.float32,
                               device="cpu")
        out = []
        with torch.no_grad():
            for i in range(6):
                logits, st = decode_step(cfg, params, st, toks[:, i:i + 1])
                out.append(logits)
        return torch.cat(out)

    plain = run()
    set_mesh(cpu_mesh(1, model))
    assert attn.DECODE_HEADDIM_SHARD
    assert torch.equal(run(), plain)


@pytest.mark.parametrize("h,d,flag,want", [
    (24, 128, True, (None, None, None, "model")),   # phi4-mini: head_dim
    (24, 128, False, None),                         # nothing divides
    (32, 64, True, (None, None, "model", None)),    # llama: heads
    (32, 64, False, (None, None, "model", None)),
])
def test_decode_headdim_shard_picks_the_reference_decode_spec(
        h, d, flag, want, monkeypatch):
    """``DECODE_HEADDIM_SHARD`` picks between the reference's two decode
    hint branches (its ``attention.py:365-371``) on the production
    model axis of 16; the spec ``hint`` resolves shows the pick."""
    monkeypatch.setattr(attn, "DECODE_HEADDIM_SHARD", flag)
    shape = (2, 4096, h, d)
    assert hint_spec(shape, *attn.decode_kv_axes(h, d)) is None
    set_mesh(make_production_mesh(multi_pod=False))
    assert hint_spec(shape, *attn.decode_kv_axes(h, d)) == want


# ---------------------------------------------------------------------------
# LMTrainer on a client mesh, launch.train --mesh
# ---------------------------------------------------------------------------

def test_lm_trainer_on_a_client_mesh_is_the_looped_local_train():
    cfg = get_arch("llama3.2-1b").reduced()
    tr = LMTrainer(cfg, FLConfig(n_clients=4, local_epochs=2), seq_len=32,
                   batch=2, corpus_tokens=20_000, device="cpu")
    mesh = make_client_mesh(4, devices=["cpu"] * 4)

    def wrap(fn, replicated):
        return shard_cohort_train(mesh, fn, replicated=replicated)

    params = tr.init_params(0)
    ids = [2, 0, 3]
    batch, sizes = tr.local_train_batch(params, ids, 7, wrap=wrap)
    again, _ = tr.local_train_batch(params, ids, 7, wrap=wrap)
    starts = [tr.init_params(s) for s in (1, 2, 3)]
    stacked = jax.tree_util.tree_map(lambda *x: torch.stack(x), *starts)
    cohort, _ = tr.local_train_cohort(stacked, ids, [4, 5, 6], wrap=wrap)
    for pos, c in enumerate(ids):
        one, n = tr.local_train(params, c, 7)
        assert sizes[pos] == n
        from_start, _ = tr.local_train(starts[pos], c, 4 + pos)
        for a, b, r, x, y in zip(tree_leaves(batch), tree_leaves(one),
                                 tree_leaves(again), tree_leaves(cohort),
                                 tree_leaves(from_start)):
            assert torch.equal(a[pos], b) and torch.equal(r[pos], b)
            assert torch.equal(x[pos], y)


def test_lm_trainer_padding_row_trains_once_on_both_routes(monkeypatch):
    """The engine pads a cohort by repeating its last row: on either
    route (looped, or split over a client mesh whose shard holds the
    repeat) that row reuses the model before it."""
    cfg = get_arch("llama3.2-1b").reduced()
    tr = LMTrainer(cfg, FLConfig(n_clients=4, local_epochs=2), seq_len=16,
                   batch=2, corpus_tokens=20_000, device="cpu")
    steps = []
    step = tr._step
    monkeypatch.setattr(tr, "_step", lambda *a: steps.append(1) or step(*a))
    mesh = make_client_mesh(2, devices=["cpu"] * 2)

    def wrap(fn, replicated):
        return shard_cohort_train(mesh, fn, replicated=replicated)

    params = tr.init_params(0)
    ids = [2, 0, 3, 3]
    looped, _ = tr.local_train_batch(params, ids, 7)
    assert len(steps) == 3 * 2
    meshed, _ = tr.local_train_batch(params, ids, 7, wrap=wrap)
    assert len(steps) == 2 * 3 * 2
    for a, b in zip(tree_leaves(looped), tree_leaves(meshed)):
        assert torch.equal(a, b) and torch.equal(a[3], a[2])


def test_fl_train_lm_on_a_client_mesh(monkeypatch, capsys):
    argv = ["--rounds", "1", "--clients", "4", "--tiers", "2", "--tau", "1",
            "--device", "cpu"]
    plain = fl_train.main(argv)
    monkeypatch.setenv(ENV_VAR, "--force_client_shards=4")
    meshed = fl_train.main(argv + ["--mesh-clients", "4"])
    assert "[fl_train] client mesh: 4 device(s)" in capsys.readouterr().out
    assert meshed.meta["mesh_devices"] == 4
    assert meshed.rounds == plain.rounds and meshed.times == plain.times
    np.testing.assert_allclose(meshed.accuracy, plain.accuracy, atol=5e-3)


def test_train_cli_under_a_mesh_gives_the_same_losses(monkeypatch, capsys):
    real = train.make_token_dataset
    monkeypatch.setattr(train, "make_token_dataset",
                        lambda vocab, n, seed: real(vocab, 5_000, seed=seed))
    argv = ["--device", "cpu", "--steps", "2", "--batch", "2", "--seq",
            "64", "--log-every", "1"]
    plain = train.main(argv)
    monkeypatch.setenv(ENV_VAR, "--force_client_shards=4")
    meshed = train.main(argv + ["--mesh", "1,4"])
    assert meshed == plain
    assert "[train] mesh (data, model) = (1, 4):" in capsys.readouterr().out
    monkeypatch.delenv(ENV_VAR)
    with pytest.raises(ValueError, match="needs 4 devices"):
        train.main(argv + ["--mesh", "2,2"])
