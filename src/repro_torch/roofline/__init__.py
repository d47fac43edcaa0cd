"""Roofline terms (the JAX package's ``roofline/``) and the port's work
model: ``analysis`` is the reference's HLO parser and ``roofline_terms``
with ``H100_SXM`` as the default hardware; ``cost`` holds the kernels'
bounds and a whole step's dot FLOPs and HBM bytes, counted from the
config without a compiler."""

from repro_torch.roofline.analysis import (H100_SXM, TPU_V5E, HWSpec,
                                           analyze_hlo, roofline_terms)
from repro_torch.roofline.cost import step_cost

__all__ = ["analyze_hlo", "roofline_terms", "HWSpec", "TPU_V5E", "H100_SXM",
           "step_cost"]
