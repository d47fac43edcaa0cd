"""The JAX package's ``examples/`` scripts on the port's entry points
(``python -m repro_torch.examples.<name>``); each runs on ``cuda``
unless ``--device cpu`` is given."""
