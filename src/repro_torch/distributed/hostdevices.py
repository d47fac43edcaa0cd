"""Forced client-shard count (``REPRO_TORCH_FLAGS``) — no torch imports.

The JAX package runs its client mesh on one machine by forcing XLA to
split the CPU into N virtual host devices
(``--xla_force_host_platform_device_count=N`` in ``XLA_FLAGS``).  Torch
has no such flag, so the port keeps its own variable with the same
grammar: ``--force_client_shards=N`` in ``REPRO_TORCH_FLAGS`` makes
``make_client_mesh`` (``distributed/mesh.py``) span N virtual shards of
the default device — four shards of one GPU, or of the CPU — exactly as
the forced host devices are N virtual devices of one CPU.

* ``ensure_host_device_count`` APPENDS the flag to whatever the
  variable already holds; a count that is already present wins, so an
  explicit operator choice is never clobbered.
* ``forced_host_device_count`` reports the count in effect, ``None``
  when none is forced (the real device count applies).

Both take an optional ``env`` mapping in place of ``os.environ``.
"""

from __future__ import annotations

import os
import re
from typing import MutableMapping, Optional

ENV_VAR = "REPRO_TORCH_FLAGS"
_FLAG = "--force_client_shards"


def forced_host_device_count(
        env: Optional[MutableMapping[str, str]] = None) -> Optional[int]:
    """The forced client-shard count in ``REPRO_TORCH_FLAGS``, or
    ``None`` when the flag is absent."""
    flags = (os.environ if env is None else env).get(ENV_VAR, "")
    m = re.search(re.escape(_FLAG) + r"=(\d+)", flags)
    return int(m.group(1)) if m else None


def ensure_host_device_count(
        n: int, env: Optional[MutableMapping[str, str]] = None) -> int:
    """Append ``--force_client_shards=n`` to ``REPRO_TORCH_FLAGS``,
    keeping what the variable already holds.

    A forced count that is already present wins and is returned
    unchanged.  Returns the count now in effect.  A client mesh reads
    the variable when it is made, so set it before ``make_client_mesh``.
    """
    env = os.environ if env is None else env
    existing = forced_host_device_count(env)
    if existing is not None:
        return existing
    if n < 1:
        raise ValueError(f"host device count must be >= 1, got {n}")
    flags = env.get(ENV_VAR, "")
    env[ENV_VAR] = (flags + " " if flags else "") + f"{_FLAG}={int(n)}"
    return int(n)
