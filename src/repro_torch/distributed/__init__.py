"""Client-sharded distributed execution.

Splits FL cohorts over a 1-D ``("clients",)`` mesh: ``make_client_mesh``
builds the mesh (every visible GPU, or N virtual shards of one device
under ``ensure_host_device_count(N)``), ``ClientShardingPlan`` pads
cohorts to mesh multiples with exact-no-op rows, ``shard_cohort_train``
runs local epochs shard by shard, and ``sharded_aggregate`` /
``sharded_staleness_merge`` add per-shard partial sums (kernel
``fedagg_partial``).  ``ShardedClientEngine`` packages it all behind
the ``BatchedClientEngine`` interface; schedulers select it via
``make_engine(..., mesh=...)``.

``hostdevices`` (environment plumbing, no torch) loads eagerly;
everything else loads on first attribute access, as the reference's
package does.
"""

from repro_torch.distributed.hostdevices import (ensure_host_device_count,
                                                 forced_host_device_count)

_LAZY = {
    "CLIENT_AXIS": "mesh",
    "ClientMesh": "mesh",
    "Mesh": "mesh",
    "make_mesh": "mesh",
    "client_devices": "mesh",
    "make_client_mesh": "mesh",
    "ClientShardingPlan": "plan",
    "sharded_aggregate": "aggregate",
    "sharded_staleness_merge": "aggregate",
    "ShardedClientEngine": "engine",
    "shard_cohort_train": "engine",
}

__all__ = ["ensure_host_device_count", "forced_host_device_count",
           *sorted(_LAZY)]


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)


def __dir__():
    return sorted(set(globals()) | set(__all__))
