"""numpy tree <-> torch tree: bit-exact round trips and the reference's
leaf order."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.config import get_arch
from repro.models.cnn import init_cnn
from repro_torch import bridge
from repro_torch.tree import (tree_flatten, tree_leaves, tree_map,
                              tree_stack, tree_unflatten)

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ["cnn-mnist", "resnet8-cifar10"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_reference_params_round_trip_bit_exactly(arch, dtype):
    cfg = get_arch(arch)
    if not cfg.resnet:
        cfg = cfg.reduced()
    params_np = jax.device_get(init_cnn(cfg, jax.random.PRNGKey(0),
                                        dtype=dtype))
    back = bridge.to_numpy(bridge.from_reference(params_np, "cpu"))
    want = jax.tree_util.tree_leaves(params_np)
    got = jax.tree_util.tree_leaves(back)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    pt_leaves = tree_leaves(bridge.from_reference(params_np, "cpu"))
    for leaf, w in zip(pt_leaves, want):      # same leaf order
        assert tuple(leaf.shape) == w.shape
        if w.dtype == ml_dtypes.bfloat16:
            assert leaf.dtype == torch.bfloat16
            np.testing.assert_array_equal(leaf.float().numpy(),
                                          w.astype(np.float32))


def test_leaf_order_is_jax_tree_util_order():
    tree = {"z": np.float32(1), "a": [np.float32(2), {"y": np.float32(3),
                                                      "b": np.float32(4)}],
            "m": (np.float32(5), None, np.float32(6))}
    want = [float(x) for x in jax.tree_util.tree_leaves(tree)]
    assert [float(x) for x in tree_leaves(tree)] == want
    leaves, treedef = tree_flatten(tree)
    assert tree_unflatten(treedef, leaves) == tree
    assert {treedef: 1}[tree_flatten(tree)[1]] == 1     # hashable, equal


def test_tree_map_and_stack():
    a = {"w": torch.ones(2), "l": [torch.zeros(1)]}
    b = tree_map(lambda x, y: x + 2 * y, a, a)
    assert torch.equal(b["w"], torch.full((2,), 3.0))
    s = tree_stack([a, b])
    assert s["w"].shape == (2, 2) and s["l"][0].shape == (2, 1)
    with pytest.raises(ValueError):
        tree_map(lambda x, y: x, a, {"w": torch.ones(2)})


def test_bridge_copies_so_torch_cannot_write_into_the_source():
    src = np.zeros(3, np.float32)
    t = bridge.to_torch({"a": src}, "cpu")["a"]
    t += 1
    assert not src.any()


@pytest.mark.parametrize("fn", ["from_reference", "to_torch"])
def test_bridge_defaults_to_the_card_and_raises_without_one(fn,
                                                            monkeypatch):
    """Like every entry point of the port, the bridge puts its trees on
    ``cuda`` unless ``"cpu"`` is asked for: with no CUDA device and no
    device named it raises; ``"cpu"`` still works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = {"w": np.ones((2, 3), np.float32)}
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(bridge, fn)(tree)
    got = getattr(bridge, fn)(tree, "cpu")
    assert got["w"].device.type == "cpu"
