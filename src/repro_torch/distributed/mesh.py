"""Client-axis mesh: the devices a cohort's rows are split over.

The FL client axis is embarrassingly parallel, so the distributed
engine splits cohorts over a 1-D ``("clients",)`` mesh.  In the port a
mesh is a tuple of ``torch.device``s, one per shard, in shard order;
a device may repeat.  ``[cuda:0] * 4`` is four virtual shards of one
card, the counterpart of the JAX package's forced host devices
(``distributed/hostdevices.py``): each shard's rows are trained and
reduced on their own, and the shard partials are added on the first
device.  Runs over more than one physical GPU are written for but
unverified.

A function, not a module-level constant: importing this module never
touches CUDA state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.distributed.hostdevices import forced_host_device_count

CLIENT_AXIS = "clients"


@dataclass(frozen=True)
class ClientMesh:
    """A 1-D client mesh: ``devices[i]`` runs shard ``i``."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (CLIENT_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)


def _normalize(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def client_devices(device=None) -> list:
    """The devices a client mesh may span: ``N`` virtual shards of
    ``device`` under a forced count of ``N``, else every visible CUDA
    device when ``device`` is a CUDA device, else ``device`` alone.
    ``device=None`` is the current CUDA device and raises when there is
    none (``resolve_device``): a CPU mesh is asked for by name,
    ``client_devices("cpu")``."""
    dev = _normalize(resolve_device(device))
    forced = forced_host_device_count()
    if forced is not None:
        return [dev] * forced
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def make_client_mesh(clients: Optional[int] = None, *,
                     devices: Optional[Sequence] = None) -> ClientMesh:
    """1-D ``("clients",)`` mesh over the first ``clients`` devices.

    ``devices=None`` spans ``client_devices()``, so it raises with no
    CUDA device (pass ``devices=["cpu"] * n`` or
    ``client_devices("cpu")``); ``clients=None`` spans
    every one of them; a request larger than that is clamped, so
    ``--mesh-clients 8`` degrades to the devices there are.
    """
    devs = [_normalize(d) for d in (devices if devices is not None
                                    else client_devices())]
    n = len(devs) if clients is None else int(clients)
    if n < 1:
        raise ValueError(f"client mesh needs at least one device, got {n}")
    return ClientMesh(tuple(devs[:min(n, len(devs))]))
