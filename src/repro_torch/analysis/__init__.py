"""`fedlint` for the port: repo-invariant static analysis with the JAX
package's rule codes (FED001..FED007), waiver syntax and CLI, its rules
rewritten for PyTorch (``repro_torch.analysis.rules``): views of the
store's buffers held across its in-place row writes, host syncs in the
round's hot path (``.item()``, ``.cpu()``, ``torch.cuda.synchronize``,
...), FMA-contractible ``a*b + c`` in bit-gated code, eager telemetry
arguments and uncatalogued names, kernel builds and ``torch.compile``
per call, torch's global RNG in seeded paths, broad ``except``:

    PYTHONPATH=src python -m repro_torch.analysis.fedlint src/repro_torch \\
        tests/test_torch_*.py chip_smoke.py tools

The driver and CLI (``core``, ``waivers``, ``fedlint``) are the
reference's, which are framework-free.
"""

from repro_torch.analysis.core import Finding, lint_paths
from repro_torch.analysis.rules import RULES

__all__ = ["Finding", "lint_paths", "RULES"]
