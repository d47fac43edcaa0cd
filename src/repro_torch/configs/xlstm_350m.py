"""xLSTM 350M — alternating sLSTM + mLSTM blocks [arXiv:2405.04517].

d_ff=0: xLSTM blocks carry their own up-projection (proj_factor)."""

from repro_torch.config.base import ModelConfig, register_arch


@register_arch("xlstm-350m")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="xlstm-350m",
        family="ssm",
        num_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        activation="gelu",
        ssm_state=0,
        slstm_every=2,           # every 2nd block is sLSTM (alternating)
        proj_factor=2.0,
        citation="arXiv:2405.04517",
    )
