"""Assigned input shapes (re-exported from config.base for convenience)."""

from repro_torch.config.base import INPUT_SHAPES, InputShape  # noqa: F401
