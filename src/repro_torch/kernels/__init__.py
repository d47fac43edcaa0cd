from repro_torch.kernels.ops import fedagg_op, fedagg_pytree

__all__ = ["fedagg_op", "fedagg_pytree"]
