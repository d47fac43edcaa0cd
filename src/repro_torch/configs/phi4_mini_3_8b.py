"""Phi-4-mini 3.8B — dense, RoPE + SwiGLU + GQA [arXiv:2412.08905]."""

from repro_torch.config.base import ModelConfig, register_arch


@register_arch("phi4-mini-3.8b")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="phi4-mini-3.8b",
        family="dense",
        num_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=200064,
        activation="swiglu",
        citation="arXiv:2412.08905",
    )
