"""IBM Granite 20B (code) — llama-arch dense, MQA (kv=1) [arXiv:2405.04324]."""

from repro_torch.config.base import ModelConfig, register_arch


@register_arch("granite-20b")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="granite-20b",
        family="dense",
        num_layers=52,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,            # MQA
        d_ff=24576,
        vocab_size=49152,
        activation="gelu",       # granite-20b-code uses gelu MLP
        citation="arXiv:2405.04324",
    )
