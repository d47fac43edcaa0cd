"""Mesh factories (the JAX package's ``launch/mesh.py``).

Functions, not module-level constants: importing this module never
touches CUDA state.  The single-pod production mesh is 16x16 = 256
devices ("data", "model"); multi-pod is 2x16x16 = 512 with a leading
"pod" axis (pure data parallelism across pods).  No machine the port
runs on has 256 GPUs, so the production meshes are made of ``meta``
devices: the sharding rules and the dry run read their names and
shape, and nothing runs on them.

``make_host_mesh`` spans the devices there are (``distributed.mesh.
client_devices``): every visible GPU, or N virtual shards of one device
under ``--force_client_shards=N`` in ``REPRO_TORCH_FLAGS`` -- the
counterpart of the reference's forced host devices.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.mesh import Mesh, client_devices, make_mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devices = np.empty(shape, dtype=object)
    devices.fill(torch.device("meta"))
    return Mesh(devices, axes)


def make_host_mesh(*, data: int = 1, model: int = 1, device=None) -> Mesh:
    """Small ("data", "model") mesh over whatever devices exist
    (``client_devices(device)``), clamped to them as the reference's:
    ``data`` to the device count, ``model`` to what is left."""
    devs = client_devices(device)
    n = len(devs)
    data = min(data, n)
    model = max(min(model, n // max(data, 1)), 1)
    return make_mesh((data, model), ("data", "model"), devices=devs)


def make_client_mesh(clients=None, *, devices=None):
    """1-D FL client-axis mesh (the distributed engine's mesh); defined
    in ``repro_torch.distributed.mesh``, re-exported here so launch code
    has a single mesh-factory module.  Pass
    ``devices=m.devices.flatten()`` to carve the client axis out of
    another factory's mesh."""
    from repro_torch.distributed.mesh import make_client_mesh as _make
    return _make(clients, devices=devices)
