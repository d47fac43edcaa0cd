"""Registers the selectable architectures (``--arch <id>``): the CNN
family of the paper.  The LM configs come with the LM slice."""

from repro_torch.configs import paper_models  # noqa: F401
