"""Mixtral 8x7B — MoE 8 experts top-2, GQA, sliding window [arXiv:2401.04088]."""

from repro_torch.config.base import ModelConfig, register_arch


@register_arch("mixtral-8x7b")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="mixtral-8x7b",
        family="moe",
        num_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        activation="swiglu",
        n_experts=8,
        top_k=2,
        sliding_window=4096,
        citation="arXiv:2401.04088",
    )
