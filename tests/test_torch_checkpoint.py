"""The port's checkpoints (``repro_torch.checkpoint``) and disk cold tier
against the JAX package's: ``tests/test_checkpoint.py``'s four cases
restated for the port, then the npz files cross-read both ways bit for
bit — a checkpoint of a nested tree, and a ``DiskColdTier`` spill of
f32 / int32 and int8 / f32 / int32 rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import latest_step as ref_latest_step
from repro.checkpoint import load_checkpoint as ref_load
from repro.checkpoint import save_checkpoint as ref_save
from repro.core.residency import DiskColdTier as RefDiskColdTier
from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.core.residency import DiskColdTier
from repro_torch.tree import tree_leaves


def _tree():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "blocks": [torch.ones(2), torch.zeros(3)]},
            "opt": {"m": {"w": torch.full((2, 3), 0.5)},
                    "t": torch.tensor(7, dtype=torch.int32)}}


def _tree_np(seed=0):
    """A nested tree of numpy leaves in every dtype a store row carries."""
    rng = np.random.default_rng(seed)
    return {"b": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                  "q": rng.integers(-127, 128, size=(5,)).astype(np.int8)},
            "a": [rng.integers(-9, 9, size=(2,)).astype(np.int32),
                  np.asarray(rng.normal(), np.float32)]}


def test_roundtrip_nested_tree(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 42, tree, metadata={"note": "x"})
    assert latest_step(str(tmp_path)) == 42
    out = load_checkpoint(str(tmp_path), 42, tree)
    for x, y in zip(tree_leaves(tree), tree_leaves(out)):
        assert isinstance(y, torch.Tensor) and x.dtype == y.dtype
        assert torch.equal(x, y)


def test_latest_step_picks_max(tmp_path):
    t = {"w": torch.zeros(2)}
    for s in (1, 5, 3):
        save_checkpoint(str(tmp_path), s, t)
    assert latest_step(str(tmp_path)) == 5


def test_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 0, {"w": torch.zeros(2)})
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path), 0, {"w": torch.zeros(3)})


def test_latest_step_empty(tmp_path):
    assert latest_step(str(tmp_path / "nope")) is None


def test_sidecar_and_file_names_equal_the_reference(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    tree = _tree_np(1)
    ref_path = ref_save(str(tmp_path / "ref"), 7, tree, metadata={"k": 1})
    port_path = save_checkpoint(str(tmp_path / "port"), 7, tree,
                                metadata={"k": 1})
    assert ref_path.rsplit("/", 1)[1] == port_path.rsplit("/", 1)[1]
    with open(ref_path + ".json") as f, open(port_path + ".json") as g:
        assert f.read() == g.read()
    with np.load(ref_path) as a, np.load(port_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_read_between_the_packages(tmp_path, writer):
    tree = _tree_np(2)
    if writer == "reference":
        ref_save(str(tmp_path), 3, jax.tree_util.tree_map(jnp.asarray,
                                                          tree))
    else:
        save_checkpoint(str(tmp_path), 3, {
            "b": {"w": torch.from_numpy(tree["b"]["w"]),
                  "q": torch.from_numpy(tree["b"]["q"])},
            "a": [torch.from_numpy(tree["a"][0]),
                  torch.from_numpy(tree["a"][1])]})
    assert ref_latest_step(str(tmp_path)) == latest_step(str(tmp_path)) == 3
    from_ref = ref_load(str(tmp_path), 3, tree)
    from_port = load_checkpoint(str(tmp_path), 3, tree)
    want = jax.tree_util.tree_leaves(tree)
    for got in (jax.tree_util.tree_leaves(from_ref), tree_leaves(from_port)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            g = np.asarray(g)
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _spill_rows(fmt, n, seed):
    """Templates and per-client rows of a store's row format: f32 +
    int32 sidecar, or int8 + f32 meta + int32 sidecar."""
    rng = np.random.default_rng(seed)
    widths = ((7, np.float32), (3, np.int32)) if fmt == "f32" else \
        ((7, np.int8), (4, np.float32), (3, np.int32))

    def row(w, dt):
        if dt == np.float32:
            return rng.normal(size=w).astype(dt)
        return rng.integers(-100, 100, size=w).astype(dt)

    templates = tuple(row(w, dt) for w, dt in widths)
    rows = {c: tuple(row(w, dt) for w, dt in widths) for c in range(n)
            if c % 3}
    return templates, rows


@pytest.mark.parametrize("fmt", ["f32", "q8"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_disk_cold_tier_spills_cross_read(tmp_path, writer, fmt):
    """A spill flushed by one package reloads in the other row for
    row: written rows as written, untouched rows as the template."""
    n, chunk = 7, 2
    templates, rows = _spill_rows(fmt, n, seed=5)
    w_cls, r_cls = ((RefDiskColdTier, DiskColdTier) if writer == "reference"
                    else (DiskColdTier, RefDiskColdTier))
    w = w_cls(str(tmp_path), n, *templates, chunk=chunk, cache_chunks=1)
    for c, segs in rows.items():
        w.write([c], *segs)
    w.flush()
    for reader in (r_cls, w_cls):
        got = reader(str(tmp_path), n, *templates, chunk=chunk).read(
            list(range(n)))
        for j, t in enumerate(templates):
            seg = np.asarray(got[j])
            assert seg.dtype == t.dtype
            for c in range(n):
                want = rows[c][j] if c in rows else t
                np.testing.assert_array_equal(seg[c], want)
