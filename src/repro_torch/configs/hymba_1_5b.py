"""Hymba 1.5B — hybrid: parallel attention + mamba heads [arXiv:2411.13676]."""

from repro_torch.config.base import ModelConfig, register_arch


@register_arch("hymba-1.5b")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="hymba-1.5b",
        family="hybrid",
        num_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,
        activation="swiglu",
        ssm_state=16,
        ssm_expand=2,
        hybrid_parallel=True,
        sliding_window=1024,     # hymba uses SWA in most layers
        citation="arXiv:2411.13676",
    )
