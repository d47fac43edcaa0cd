"""CNN / ResNet8, optimizer and CNNTrainer of the port against the JAX
package on the same numpy inputs, reference parameters carried over by
the bridge.  Tolerance rtol=1e-4, atol=1e-5 in f32: convolutions and
GEMMs sum in another order in the two frameworks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch
from repro.config.base import ModelConfig
from repro.models import cnn as ref_cnn
from repro.optim import make_optimizer as ref_make_optimizer
from repro_torch import bridge
from repro_torch.config.base import ModelConfig as PtModelConfig
from repro_torch.models import cnn as pt_cnn
from repro_torch.optim import make_optimizer as pt_make_optimizer
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5

CNN_KW = dict(arch_id="cnn-small", family="cnn", cnn_channels=(4, 8),
              cnn_fc=(16, 10), input_hw=(8, 8, 1), n_classes=10)
# stride-2 stages on even sizes (asymmetric SAME padding) and 1x1
# projections, as ResNet8 has them
RESNET_KW = dict(arch_id="resnet-small", family="cnn",
                 cnn_channels=(4, 8, 16), cnn_fc=(10,), input_hw=(8, 8, 3),
                 n_classes=10, resnet=True)
KWS = {"cnn": CNN_KW, "resnet": RESNET_KW}


def _setup(kind, batch=6, seed=0):
    ref_cfg, pt_cfg = ModelConfig(**KWS[kind]), PtModelConfig(**KWS[kind])
    params_ref = ref_cnn.init_cnn(ref_cfg, jax.random.PRNGKey(seed))
    params_np = jax.device_get(params_ref)
    rng = np.random.default_rng(seed + 1)
    # the reference initializes biases and norm scales to constants;
    # perturb every leaf so that each one matters to the comparison
    params_np = jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(a.dtype),
        params_np)
    params_ref = jax.tree_util.tree_map(jnp.asarray, params_np)
    params_pt = bridge.from_reference(params_np, "cpu")
    x = rng.normal(size=(batch,) + ref_cfg.input_hw).astype(np.float32)
    y = rng.integers(0, 10, batch).astype(np.int32)
    return ref_cfg, pt_cfg, params_ref, params_pt, x, y


def _close(got_tree, want_tree, rtol=RTOL, atol=ATOL):
    got = [l.detach().numpy() for l in tree_leaves(got_tree)]
    want = [np.asarray(l) for l in jax.tree_util.tree_leaves(want_tree)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _pt_grads(cfg, params, x, y, im2col):
    leaves = [l.clone().requires_grad_(True) for l in tree_leaves(params)]
    it = iter(leaves)
    p = tree_map(lambda _: next(it), params)
    loss = pt_cnn.cnn_loss(cfg, p, {"x": torch.from_numpy(x),
                                    "y": torch.from_numpy(y)}, im2col=im2col)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


@pytest.mark.parametrize("im2col", [False, True])
@pytest.mark.parametrize("kind", ["cnn", "resnet"])
def test_logits_and_loss_match_reference(kind, im2col):
    ref_cfg, pt_cfg, p_ref, p_pt, x, y = _setup(kind)
    want = ref_cnn.cnn_forward(ref_cfg, p_ref, jnp.asarray(x), im2col=im2col)
    got = pt_cnn.cnn_forward(pt_cfg, p_pt, torch.from_numpy(x), im2col=im2col)
    assert got.shape == (6, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    loss_ref = ref_cnn.cnn_loss(ref_cfg, p_ref, {"x": jnp.asarray(x),
                                                 "y": jnp.asarray(y)},
                                im2col=im2col)
    loss_pt = pt_cnn.cnn_loss(pt_cfg, p_pt, {"x": torch.from_numpy(x),
                                             "y": torch.from_numpy(y)},
                              im2col=im2col)
    np.testing.assert_allclose(float(loss_pt), float(loss_ref), rtol=RTOL)


@pytest.mark.parametrize("stride,k,hw", [(1, 3, 8), (2, 3, 8), (2, 1, 8),
                                         (2, 3, 7), (1, 3, 5)])
def test_conv_and_im2col_match_reference_conv(stride, k, hw):
    rng = np.random.default_rng(stride * 10 + k)
    x = rng.normal(size=(2, hw, hw, 3)).astype(np.float32)
    w = rng.normal(size=(k, k, 3, 5)).astype(np.float32)
    want = np.asarray(ref_cnn._conv(jnp.asarray(x), jnp.asarray(w), stride))
    for fn in (pt_cnn._conv, pt_cnn._conv_im2col):
        got = fn(torch.from_numpy(x), torch.from_numpy(w), stride).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_pool_and_norm_act_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 6, 8, 3)).astype(np.float32)
    s = rng.normal(size=(3,)).astype(np.float32)
    np.testing.assert_array_equal(
        pt_cnn._pool(torch.from_numpy(x)).numpy(),
        np.asarray(ref_cnn._pool(jnp.asarray(x))))
    odd = x[:, :5, :7]
    np.testing.assert_array_equal(
        pt_cnn._pool(torch.from_numpy(odd.copy())).numpy(),
        np.asarray(ref_cnn._pool(jnp.asarray(odd))))
    np.testing.assert_allclose(
        pt_cnn._norm_act(torch.from_numpy(x), torch.from_numpy(s)).numpy(),
        np.asarray(ref_cnn._norm_act(jnp.asarray(x), jnp.asarray(s))),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hw", [(5, 5), (4, 7), (6, 8)])
def test_pool_gradient_on_ties_matches_reference(hw):
    """Tied maxima: on odd sizes the reference's ``reduce_window`` sends
    a window's whole gradient to its first maximum (row-major); on even
    sizes its reshape + max splits it evenly.  The port must route it
    the same way, also under a leading client axis."""
    rng = np.random.default_rng(7)
    x = np.round(rng.uniform(0, 2, size=(2, 3) + hw + (2,))).astype(
        np.float32)                          # values in {0, 1, 2}: ties
    w = rng.normal(size=(2, 3, hw[0] // 2, hw[1] // 2, 2)).astype(
        np.float32)
    want = jax.vmap(jax.grad(
        lambda a, b: jnp.sum(ref_cnn._pool(a) * b)))(jnp.asarray(x),
                                                     jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    (pt_cnn._pool(xt) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("im2col", [False, True])
@pytest.mark.parametrize("kind", ["cnn", "resnet"])
def test_one_step_grads_match_reference(kind, im2col):
    ref_cfg, pt_cfg, p_ref, p_pt, x, y = _setup(kind)
    want = jax.grad(lambda p: ref_cnn.cnn_loss(
        ref_cfg, p, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
        im2col=im2col))(p_ref)
    _, got = _pt_grads(pt_cfg, p_pt, x, y, im2col)
    _close(got, want)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adamw"])
def test_optimizer_steps_match_reference(name):
    ref_cfg, pt_cfg, p_ref, p_pt, x, y = _setup("cnn")
    g_ref = jax.grad(lambda p: ref_cnn.cnn_loss(
        ref_cfg, p, {"x": jnp.asarray(x), "y": jnp.asarray(y)}))(p_ref)
    g_pt = bridge.from_reference(jax.device_get(g_ref), "cpu")
    opt_ref, opt_pt = ref_make_optimizer(name), pt_make_optimizer(name)
    s_ref, s_pt = opt_ref.init(p_ref), opt_pt.init(p_pt)
    for _ in range(3):                       # the step count matters to Adam
        u_ref, s_ref = opt_ref.update(g_ref, s_ref, p_ref, 1e-3)
        u_pt, s_pt = opt_pt.update(g_pt, s_pt, p_pt, 1e-3)
        _close(u_pt, u_ref, rtol=1e-5, atol=1e-9)
    if name.startswith("adam"):
        assert s_pt["t"].dtype == torch.int32 and int(s_pt["t"]) == 3
        _close(s_pt["v"], s_ref["v"], rtol=1e-6, atol=0)


def test_adam_runs_with_a_leading_client_axis():
    _, _, _, p_pt, _, _ = _setup("cnn")
    rng = np.random.default_rng(5)
    g = tree_map(lambda l: torch.from_numpy(
        rng.normal(size=(3,) + tuple(l.shape)).astype(np.float32)), p_pt)
    stacked = tree_map(lambda l: l.unsqueeze(0).expand(3, *l.shape), p_pt)
    opt = pt_make_optimizer("adam")
    ups, _ = opt.update(g, opt.init(stacked), stacked, 1e-3)
    for c in range(3):
        one, _ = opt.update(tree_map(lambda l: l[c], g), opt.init(p_pt),
                            p_pt, 1e-3)
        for a, b in zip(tree_leaves(ups), tree_leaves(one)):
            assert torch.equal(a[c], b)


def test_clip_and_schedules_match_reference():
    from repro.optim import clip_by_global_norm as ref_clip
    from repro.optim import linear_warmup_cosine as ref_sched
    from repro_torch.optim import clip_by_global_norm as pt_clip
    from repro_torch.optim import linear_warmup_cosine as pt_sched
    _, _, p_ref, p_pt, _, _ = _setup("cnn")
    c_ref, n_ref = ref_clip(p_ref, 0.5)
    c_pt, n_pt = pt_clip(p_pt, 0.5)
    np.testing.assert_allclose(float(n_pt), float(n_ref), rtol=1e-6)
    _close(c_pt, c_ref, rtol=1e-6, atol=1e-8)
    a, b = ref_sched(1e-3, 10, 100), pt_sched(1e-3, 10, 100)
    for step in (0, 5, 10, 55, 100, 150):
        np.testing.assert_allclose(float(b(step)), float(a(step)), rtol=1e-5)


def test_init_cnn_is_seeded_and_shaped_like_the_reference():
    from repro_torch.config import get_arch as pt_get_arch
    for arch in ("cnn-fmnist", "resnet8-cifar10"):
        cfg = pt_get_arch(arch)
        a = pt_cnn.init_cnn(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
        b = pt_cnn.init_cnn(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
        ref = jax.device_get(ref_cnn.init_cnn(get_arch(arch),
                                              jax.random.PRNGKey(1)))
        ref_leaves = jax.tree_util.tree_leaves(ref)
        assert len(tree_leaves(a)) == len(ref_leaves)
        for la, lb, lr in zip(tree_leaves(a), tree_leaves(b), ref_leaves):
            assert torch.equal(la, lb)
            assert tuple(la.shape) == lr.shape
            assert float(la.abs().max()) <= 2.0   # truncated at 2 sigma
