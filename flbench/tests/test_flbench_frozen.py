"""The frozen copies in ``flbench/frozen`` against the program's current
output: the same images, partition, delays, bounds and model sizes."""

import json

import numpy as np
import pytest
import torch

from flbench.frozen import cost, network, partition, synthetic
from flbench.tests.conftest import ROOT


@pytest.mark.parametrize("name,n_full", [("mnist", 60_000),
                                         ("fmnist", 60_000),
                                         ("cifar10", 50_000)])
@pytest.mark.parametrize("seed", [0, 2 ** 33 + 17])
def test_images_equal_the_programs(name, n_full, seed):
    from repro_torch.data.synthetic import make_image_dataset
    scale = 0.004
    ours = synthetic.make_image_dataset(name, seed, int(n_full * scale),
                                        int(10_000 * scale))
    theirs = make_image_dataset(name, seed=seed, scale=scale)
    for k in ("x_train", "y_train", "x_test", "y_test"):
        assert ours[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(ours[k], theirs[k])


@pytest.mark.parametrize("seed", [0, 2 ** 33 + 17])
def test_classes_seed_draws_only_the_prototypes(seed):
    """The run's own seed as ``classes_seed`` gives the program's images;
    another draws other classes under the same labels, shifts and
    noise."""
    from repro_torch.data.synthetic import make_image_dataset
    theirs = make_image_dataset("mnist", seed=seed, scale=0.004)
    same = synthetic.make_image_dataset("mnist", seed, 240, 40, seed)
    other = synthetic.make_image_dataset("mnist", seed, 240, 40, 2307)
    for k in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(same[k], theirs[k])
    np.testing.assert_array_equal(other["y_train"], theirs["y_train"])
    assert not np.array_equal(other["x_train"], theirs["x_train"])


@pytest.mark.parametrize("frac", [0.0, 0.7, 0.95])
@pytest.mark.parametrize("n_clients", [8, 50])
def test_partition_equals_the_programs(frac, n_clients):
    from repro_torch.data.partition import primary_class_partition
    labels = np.random.default_rng(3).integers(0, 10, 1_000).astype(np.int32)
    ours = partition.primary_class_partition(labels, n_clients, frac, seed=5)
    theirs = primary_class_partition(labels, n_clients, frac, seed=5)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mu", [0.0, 0.2])
@pytest.mark.parametrize("seed", [0, 3_000_000_001])
def test_delays_equal_the_programs(mu, seed):
    from repro_torch.fl.network import WirelessNetwork
    args = (40, (5.0, 10.0, 15.0, 20.0, 25.0), 2.0, mu, (30.0, 60.0), seed)
    ours, theirs = network.WirelessNetwork(*args), WirelessNetwork(*args)
    clients = np.arange(40)
    for rnd in (0, 1, 57):
        np.testing.assert_array_equal(ours.delays(clients, rnd),
                                      theirs.delays(clients, rnd))
    np.testing.assert_array_equal(
        ours.delays([3] * 4, 9, attempt=np.arange(4) + 1),
        theirs.delays([3] * 4, 9, attempt=np.arange(4) + 1))
    assert ours.delay(7, 11, 2) == theirs.delay(7, 11, 2)


@pytest.mark.parametrize("rows,live,p", [(5, 5, 1_630_090), (32, 20, 77_594),
                                         (128, 100, 1_630_090)])
def test_kernel_bounds_equal_the_programs(rows, live, p):
    from repro_torch.roofline import cost as pcost
    w = torch.zeros(rows)
    w[:live] = 1.0
    assert cost.k1_bound_s(rows, live, p) * 1e3 == pytest.approx(
        pcost.fedagg_bound_ms(w, p)[0], rel=1e-12)
    coef = torch.zeros(rows + 1)
    coef[:live + 1] = 0.5
    assert cost.k2_bound_s(rows, live, p) * 1e3 == pytest.approx(
        pcost.fold_bound_ms(coef, p)[0], rel=1e-12)
    assert cost.HBM_BYTES_PER_S == pcost.HBM_BYTES_PER_S
    assert cost.F32_FLOPS_PER_S == pcost.F32_FLOPS_PER_S
    assert cost.TF32_TENSOR_FLOPS_PER_S == pcost.TF32_TENSOR_FLOPS_PER_S


@pytest.mark.parametrize("config,params", [("cnn-mnist", 1_630_090),
                                           ("resnet8-cifar10", 77_594)])
def test_model_sizes_equal_the_programs(config, params):
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.config import get_arch
    from repro_torch.models.cnn import cnn_forward, init_cnn
    cfg = json.loads((ROOT / "flbench" / "configs" / f"{config}.json")
                     .read_text())
    arch = get_arch(cfg["arch"])
    p = init_cnn(arch, torch.Generator().manual_seed(0), device="cpu")
    from flbench.bench import named_leaves
    assert cost.cnn_param_count(cfg) == params == cfg["params"] == sum(
        t.numel() for _, t in named_leaves(p))
    x = torch.zeros((2, *cfg["input_hw"]))
    with FlopCounterMode(display=False) as fc:
        cnn_forward(arch, p, x)
    assert fc.get_total_flops() == 2 * 2 * cost.cnn_forward_macs(cfg)
    assert cost.cnn_train_flops(cfg) == 3 * cost.cnn_eval_flops(cfg)
