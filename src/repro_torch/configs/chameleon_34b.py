"""Chameleon 34B — early-fusion VLM, VQ image tokens [arXiv:2405.09818].

Backbone only: the VQ-GAN image tokenizer is a stub — images arrive as
token ids inside the unified vocab (65536 includes 8192 VQ codes)."""

from repro_torch.config.base import ModelConfig, register_arch


@register_arch("chameleon-34b")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="chameleon-34b",
        family="vlm",
        num_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab_size=65536,
        activation="swiglu",
        frontend="vq_patches",
        image_tokens=1024,
        citation="arXiv:2405.09818",
    )
