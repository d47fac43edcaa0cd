"""Registers the selectable architectures (``--arch <id>``): the CNN
family of the paper, and the two LM configs the serving path runs
(``llama3.2-1b``, dense; ``hymba-1.5b``, hybrid)."""

from repro_torch.configs import hymba_1_5b, llama3_2_1b  # noqa: F401
from repro_torch.configs import paper_models  # noqa: F401
from repro_torch.configs.shapes import INPUT_SHAPES  # noqa: F401
