from repro_torch.models.cnn import cnn_forward, cnn_loss, init_cnn
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_decode_state,
    init_model,
    lm_loss,
)

__all__ = [
    "init_model", "forward", "lm_loss", "decode_step", "init_decode_state",
    "init_cnn", "cnn_forward", "cnn_loss",
]
