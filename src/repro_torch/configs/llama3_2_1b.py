"""Llama 3.2 1B — small llama3 dense GQA [hf:meta-llama/Llama-3.2-1B]."""

from repro_torch.config.base import ModelConfig, register_arch


@register_arch("llama3.2-1b")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="llama3.2-1b",
        family="dense",
        num_layers=16,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=128256,
        activation="swiglu",
        rope_theta=500_000.0,
        citation="hf:meta-llama/Llama-3.2-1B",
    )
