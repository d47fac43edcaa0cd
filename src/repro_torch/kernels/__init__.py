from repro_torch.kernels.ops import (fedagg_fold_op, fedagg_fold_pytree,
                                    fedagg_op, fedagg_partial_op,
                                    fedagg_pytree, gqa_flash_attention,
                                    ssm_scan_op)

__all__ = ["fedagg_op", "fedagg_pytree", "fedagg_fold_op",
           "fedagg_fold_pytree", "fedagg_partial_op", "gqa_flash_attention",
           "ssm_scan_op"]
