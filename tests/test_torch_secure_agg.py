"""The port's secure aggregation (``core/secure_agg.py``) against the
JAX package's: the pair seeds are the reference's exactly; the masks
are drawn from a ``torch.Generator`` (JAX's PRNG cannot be reproduced
in torch), so the uploads differ from the reference's, but the secure
average of bridged parameters equals the reference's plain weighted
average within the reference's own tolerances (rtol = atol = 1e-4 at
mask scale 50, 1e-5 at scale 1).  The server's sum goes through K3's
route (``fedagg_partial``), whose plain twin adds the rows in order:
bit for bit the reference's ``sum(xs)`` order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as ref_get_arch
from repro.core import secure_agg as ref_sa
from repro.core.aggregation import weighted_average as ref_weighted_average
from repro.models import cnn as ref_cnn
from repro_torch import bridge
from repro_torch.core import secure_agg as sa
from repro_torch.kernels import fedagg as fedagg_mod
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

SURVIVORS = [0, 2, 5, 7]
SIZES = {0: 10.0, 2: 20.0, 5: 5.0, 7: 15.0}


def _np_params(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(5, 3)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32)}


def _cnn_params(seed):
    """The reference's reduced cnn-mnist parameters, as numpy."""
    cfg = ref_get_arch("cnn-mnist").reduced()
    return jax.device_get(ref_cnn.init_cnn(cfg, jax.random.PRNGKey(seed)))


def _both(np_tree):
    return (jax.tree_util.tree_map(jnp.asarray, np_tree),
            bridge.from_reference(np_tree, "cpu"))


@pytest.mark.parametrize("base_seed", [0, 1, 12345, 2 ** 31 - 1, 10 ** 12])
def test_pair_seed_is_the_reference_seed(base_seed):
    for rnd in (0, 1, 7, 199, 10 ** 6):
        for i in range(0, 12, 3):
            for j in range(0, 12, 2):
                assert sa._pair_seed(base_seed, rnd, i, j) == \
                    ref_sa._pair_seed(base_seed, rnd, i, j)
                assert sa._pair_seed(base_seed, rnd, i, j) == \
                    sa._pair_seed(base_seed, rnd, j, i)


@pytest.mark.parametrize("kind", ["toy", "cnn"])
@pytest.mark.parametrize("scale,tol", [(50.0, 1e-4), (1.0, 1e-5)])
def test_secure_average_is_the_reference_weighted_average(kind, scale, tol):
    make = _np_params if kind == "toy" else _cnn_params
    trees = {c: _both(make(c)) for c in SURVIVORS}
    sizes = [SIZES[c] for c in SURVIVORS]
    masked = [sa.mask_update(trees[c][1], c, SURVIVORS, rnd=3,
                             weight=SIZES[c], scale=scale)
              for c in SURVIVORS]
    got = sa.secure_aggregate(masked, sizes)
    want = ref_weighted_average([trees[c][0] for c in SURVIVORS], sizes)
    ref_masked = [ref_sa.mask_update(trees[c][0], c, SURVIVORS, rnd=3,
                                     weight=SIZES[c], scale=scale)
                  for c in SURVIVORS]
    ref_got = ref_sa.secure_aggregate(ref_masked, sizes)
    got_l = tree_leaves(got)
    want_l = jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l)
    for g, w, r in zip(got_l, want_l, jax.tree_util.tree_leaves(ref_got)):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                   atol=tol)
        # the reference's own secure average meets the same tolerance
        np.testing.assert_allclose(np.asarray(r), np.asarray(w), rtol=tol,
                                   atol=tol)


def test_dropout_changes_survivor_set_but_still_cancels():
    survivors = [0, 1]
    trees = {c: _both(_np_params(c)) for c in survivors}
    masked = [sa.mask_update(trees[c][1], c, survivors, rnd=1, weight=1.0)
              for c in survivors]
    got = sa.secure_aggregate(masked, [1.0, 1.0])
    want = ref_weighted_average([trees[0][0], trees[1][0]], [1.0, 1.0])
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5)


def test_individual_upload_is_masked():
    _, p = _both(_np_params(0))
    up = sa.mask_update(p, 0, [0, 1], rnd=0, weight=1.0, scale=50.0)
    assert float((up["w"] - p["w"]).abs().max()) > 10.0
    assert float((up["b"] - p["b"]).abs().max()) > 10.0


def test_seeded_masks_repeat_and_differ_by_seed():
    _, p = _both(_cnn_params(0))
    a = sa._mask_like(p, seed=42)
    b = sa._mask_like(p, seed=42)
    c = sa._mask_like(p, seed=43)
    for x, y, z in zip(tree_leaves(a), tree_leaves(b), tree_leaves(c)):
        assert x.dtype == torch.float32
        assert torch.equal(x, y)
        assert not torch.equal(x, z)
    # the whole upload repeats bit for bit
    u1 = sa.mask_update(p, 2, SURVIVORS, rnd=5, weight=3.0, scale=50.0)
    u2 = sa.mask_update(p, 2, SURVIVORS, rnd=5, weight=3.0, scale=50.0)
    for x, y in zip(tree_leaves(u1), tree_leaves(u2)):
        assert torch.equal(x, y)


def test_masks_are_drawn_in_tree_leaves_order():
    """One generator draws the leaves in sorted-key order: the mask of a
    tree equals one long draw split at the leaves' sizes."""
    _, p = _both(_cnn_params(1))
    got = torch.cat([l.reshape(-1) for l in tree_leaves(
        sa._mask_like(p, seed=7, scale=2.0))])
    gen = torch.Generator().manual_seed(7)
    want = torch.cat([torch.randn(tuple(l.shape), generator=gen).reshape(-1)
                      for l in tree_leaves(p)]) * 2.0
    assert torch.equal(got, want)


def test_server_sum_goes_through_k3_bit_for_bit(monkeypatch):
    """On the CPU the K3 route (``fedagg_partial`` with unit
    coefficients -> ``fedagg_partial_plain`` -> ``row_sum``) equals the
    sequential sum ``0 + x0 + x1 + ...`` bit for bit, then the host's
    denominator divides it."""
    calls = []
    real = fedagg_mod.fedagg_partial_plain

    def spy(updates, coef):
        calls.append((tuple(updates.shape), torch.as_tensor(coef).clone()))
        return real(updates, coef)

    monkeypatch.setattr(fedagg_mod, "fedagg_partial_plain", spy)
    _, p = _both(_cnn_params(2))
    masked = [sa.mask_update(tree_map(lambda t: t * (c + 1), p), c,
                             SURVIVORS, rnd=9, weight=SIZES[c], scale=50.0)
              for c in SURVIVORS]
    sizes = [SIZES[c] for c in SURVIVORS]
    got = sa.secure_aggregate(masked, sizes)
    n_p = sum(l.numel() for l in tree_leaves(p))
    assert len(calls) == 1
    assert calls[0][0] == (len(SURVIVORS), n_p)
    assert torch.equal(calls[0][1], torch.ones(len(SURVIVORS)))
    denom = float(np.sum(sizes))
    for k, g in enumerate(tree_leaves(got)):
        ups = [tree_leaves(u)[k] for u in masked]
        acc = torch.zeros_like(ups[0])
        for u in ups:
            acc = acc + u
        assert torch.equal(g, acc / denom)
        # the reference's sum(xs) in numpy f32, the same order
        acc_np = np.float32(0) + np.zeros(ups[0].shape, np.float32)
        for u in ups:
            acc_np = acc_np + u.numpy()
        np.testing.assert_array_equal(acc.numpy(), acc_np)


def test_cuda_upload_takes_the_kernel_or_raises():
    """No fallback: on a CUDA upload ``fedagg_partial`` launches the
    kernel (the route does not call the plain twin)."""
    import inspect
    src = inspect.getsource(fedagg_mod.fedagg_partial)
    assert 'updates.device.type != "cuda"' in src
    assert "fedagg_partial_f32" in src
    assert inspect.getsource(sa.secure_aggregate).count("fedagg_partial(") \
        == 1
