"""Image classifiers of the paper (its MNIST CNN and CIFAR-10 ResNet8):
synthetic images of the dataset's shape, the program's ``CNNTrainer``
and the plain reference ``flbench/reference/model.py``."""

import torch

from flbench.frozen.partition import primary_class_partition
from flbench.frozen.synthetic import make_image_dataset
from flbench.reference import model as reference

# the size at which the program's trainer makes its own dataset, which
# the harness's samples replace before any round
TOKEN_SCALE = 1e-3


def make_data(cfg, tr, seed):
    """Images and their primary-class partition over the clients, from
    ``seed`` (the classes' prototypes from the traffic's
    ``classes_seed``, where it gives one: one dataset for every seed, as
    MNIST is one)."""
    n, spc = tr["clients"], tr["samples_per_client"]
    data = make_image_dataset(cfg["dataset"], seed, n * spc,
                              tr["test_samples"], tr.get("classes_seed"))
    parts = primary_class_partition(data["y_train"], n, tr["primary_frac"],
                                    seed=seed)
    if any(len(p) != spc for p in parts):
        raise ValueError("the partition left clients of unequal size")
    return {"x": data["x_train"], "y": data["y_train"], "parts": parts,
            "x_test": data["x_test"], "y_test": data["y_test"]}


def build_trainer(cfg, fl, inputs, seed, device):
    """The program's trainer for ``cfg`` (built through
    ``fl.client.build_fl_clients`` at a token size), holding the
    harness's clients and test images."""
    from repro_torch.data.pipeline import ClientDataset
    from repro_torch.fl.client import build_fl_clients
    trainer = build_fl_clients(cfg["arch"], fl, scale=TOKEN_SCALE,
                               device=device)
    pc = trainer.cfg
    stated = (tuple(cfg["cnn_channels"]), tuple(cfg["cnn_fc"]),
              tuple(cfg["input_hw"]), cfg["n_classes"], cfg["resnet"])
    have = (tuple(pc.cnn_channels), tuple(pc.cnn_fc), tuple(pc.input_hw),
            pc.n_classes, pc.resnet)
    if stated != have:
        raise ValueError(f"the program's {cfg['arch']} is {have}, the "
                         f"configuration states {stated}")
    x, y = inputs["x"], inputs["y"]
    trainer.clients = [ClientDataset(x[p], y[p]) for p in inputs["parts"]]
    trainer.x_test = torch.from_numpy(inputs["x_test"]).to(trainer.device)
    trainer.y_test = torch.from_numpy(inputs["y_test"]).long().to(
        trainer.device)
    return trainer
