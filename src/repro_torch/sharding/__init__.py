from repro_torch.sharding.hints import axis_size, hint

__all__ = ["hint", "axis_size"]
