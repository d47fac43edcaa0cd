"""The port's sharding rules and hints (``repro_torch/sharding/``)
against the JAX package's ``repro/sharding/``.

The rules read a mesh's ``axis_names`` and ``devices.shape`` and
nothing else, so the production meshes of 256 and 512 devices are
stand-ins with those two fields (as ``tests/test_sharding.py`` does).
Spec trees are compared exactly, leaf for leaf, for every assigned arch
at full width, over the reference's ``abstract_params`` and the port's
(``meta`` tensors); the hints' resolved specs against the reference's
``_expand`` / ``_size`` rule.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RefP

from repro.config import get_arch as ref_get_arch
from repro.config.base import INPUT_SHAPES as REF_SHAPES
from repro.launch import steps as ref_steps
from repro.sharding import hints as ref_hints
from repro.sharding import rules as ref_rules
from repro_torch.config import get_arch
from repro_torch.config.base import INPUT_SHAPES
from repro_torch.distributed.mesh import Mesh, make_mesh
from repro_torch.launch import dryrun, steps
from repro_torch.sharding import hints, rules
from repro_torch.sharding.rules import NamedSharding, PartitionSpec

ARCHS = dryrun.ASSIGNED


def fake_mesh(shape, names):
    class FakeMesh:
        axis_names = names

        class devices:
            pass
    FakeMesh.devices.shape = shape
    return FakeMesh()


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model"))}


def _spec_leaves(tree):
    """Port spec tree -> list of tuples in jax's leaf order."""
    if isinstance(tree, PartitionSpec):
        return [tuple(tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for c in tree for x in _spec_leaves(c)]
    raise TypeError(type(tree))


def _ref_spec_leaves(tree):
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, RefP))]


_ABSTRACT = {}


def _abstract(arch):
    if arch not in _ABSTRACT:
        _ABSTRACT[arch] = (ref_steps.abstract_params(ref_get_arch(arch)),
                           steps.abstract_params(get_arch(arch)))
    return _ABSTRACT[arch]


def test_rules_table_is_the_reference_table():
    assert rules._RULES == ref_rules._RULES


@pytest.mark.parametrize("mode", ["tp_fsdp", "fsdp_only"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference_full_width(arch, mesh, mode):
    shape, names = MESHES[mesh]
    fm = fake_mesh(shape, names)
    ref_p, port_p = _abstract(arch)
    want = _ref_spec_leaves(ref_rules.param_specs(ref_p, fm, mode=mode))
    got = _spec_leaves(rules.param_specs(port_p, fm, mode=mode))
    assert got == want


def test_param_specs_without_fsdp_equal_reference():
    fm = fake_mesh(*MESHES["16x16"])
    for arch in ("llama3.2-1b", "arctic-480b", "hymba-1.5b"):
        ref_p, port_p = _abstract(arch)
        assert _spec_leaves(rules.param_specs(port_p, fm, fsdp=False)) == \
            _ref_spec_leaves(ref_rules.param_specs(ref_p, fm, fsdp=False))


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_decode_state_specs_equal_reference(arch, mesh):
    fm = fake_mesh(*MESHES[mesh])
    cfg, ref_cfg = get_arch(arch), ref_get_arch(arch)
    for name, shape in INPUT_SHAPES.items():
        if shape.kind == "decode" and cfg.is_encoder_only:
            continue
        ref_in = ref_steps.input_specs(ref_cfg, REF_SHAPES[name])
        port_in = steps.input_specs(cfg, shape)
        for mode in ("tp_fsdp", "fsdp_only"):
            assert _spec_leaves(rules.batch_specs(port_in, fm, mode=mode)) \
                == _ref_spec_leaves(ref_rules.batch_specs(ref_in, fm,
                                                          mode=mode))
        if shape.kind == "decode":
            ref_st = ref_steps.abstract_decode_state(ref_cfg,
                                                     REF_SHAPES[name])
            port_st = steps.abstract_decode_state(cfg, shape)
            assert _spec_leaves(rules.decode_state_specs(port_st, fm)) == \
                _ref_spec_leaves(ref_rules.decode_state_specs(ref_st, fm))


def test_known_placements_and_named_shardings():
    fm = fake_mesh(*MESHES["16x16"])
    params = steps.abstract_params(get_arch("llama3.2-1b"))
    specs = rules.param_specs(params, fm)
    assert specs["embed"] == PartitionSpec("model", "data")
    assert specs["head"] == PartitionSpec(None, "model")
    assert specs["blocks"]["attn"]["wq"] == PartitionSpec(None, "data",
                                                          "model")
    sh = rules.named_shardings(specs, fm)
    assert isinstance(sh["embed"], NamedSharding)
    v, d = params["embed"].shape
    assert sh["embed"].shard_shape((v, d)) == (v // 16, d // 16)
    assert params["embed"].dtype == torch.bfloat16   # TrainConfig()
    assert sh["embed"].device_bytes(params["embed"]) == v * d * 2 // 256
    assert sh["blocks"]["ln1"].shard_shape((16, d)) == (16, d)
    with pytest.raises(ValueError, match="divide"):
        sh["embed"].shard_shape((v + 1, d))


@pytest.mark.parametrize("fsdp_only", [False, True])
@pytest.mark.parametrize("mesh", ["16x16", "2x16x16", "2x4", "1x1"])
def test_hint_spec_follows_the_reference_rule(mesh, fsdp_only):
    """``hint_spec`` against the reference's ``hint`` body (``_expand``,
    ``_size``, the divisibility drop) on the same stand-in mesh."""
    fm = fake_mesh(*MESHES[mesh])
    cases = [((8, 64, 16, 32), ("batch", None, "model", None)),
             ((2, 64, 16, 32), ("batch", None, None, "model")),
             ((512, 4096, 2048), ("batch", "model", None)),
             ((3, 5), ("batch", "model")),
             ((32, 24, 128), (None, "model", "data")),
             ((256, 1), ("batch", None)),
             ((64,), ("pod",))]
    ref_hints.set_mesh(fm, fsdp_only=fsdp_only)
    hints.set_mesh(fm, fsdp_only=fsdp_only)
    try:
        for shape, axes in cases:
            want = []
            for dim, a in zip(shape, axes):
                a = ref_hints._expand(a)
                s = ref_hints._size(a)
                want.append(a if (a is not None and s > 1 and dim % s == 0)
                            else None)
            want = None if all(w is None for w in want) else tuple(want)
            assert hints.hint_spec(shape, *axes) == want
            for name in ("batch", "model", "data", "pod"):
                assert hints.axis_size(name) == ref_hints.axis_size(name)
    finally:
        ref_hints.set_mesh(None)
        hints.set_mesh(None)


def test_hint_is_the_identity_without_a_mesh_and_checks_rank_under_one():
    x = torch.zeros(2, 3)
    assert hints.get_mesh() is None
    assert hints.hint(x, "batch") is x          # no mesh: no rank check
    assert hints.axis_size("model") == 1
    mesh = make_mesh((1, 4), ("data", "model"), devices=["cpu"] * 4)
    hints.set_mesh(mesh)
    try:
        assert hints.get_mesh() is mesh
        assert hints.axis_size("model") == 4
        assert hints.hint(x, "batch", "model") is x
        with pytest.raises(ValueError, match="rank"):
            hints.hint(x, "batch")
        with pytest.raises(ValueError, match="rank"):
            hints.hint_spec((2, 3), "batch")
    finally:
        hints.set_mesh(None)
    assert hints.hint_spec((2, 3), "batch", "model") is None


def test_a_mesh_over_two_physical_devices_raises():
    mesh = Mesh(np.array([[torch.device("cuda", 0),
                           torch.device("cuda", 1)]], dtype=object),
                ("data", "model"))
    with pytest.raises(NotImplementedError, match="item 15"):
        hints.set_mesh(mesh)
    assert hints.get_mesh() is None
    # meta devices (the production meshes) place nothing: accepted
    from repro_torch.launch.mesh import make_production_mesh
    hints.set_mesh(make_production_mesh(multi_pod=True))
    try:
        assert hints.axis_size("batch") == 32
    finally:
        hints.set_mesh(None)
