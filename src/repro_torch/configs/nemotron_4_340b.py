"""Nemotron-4 340B — dense GQA, squared-ReLU MLP [arXiv:2402.16819]."""

from repro_torch.config.base import ModelConfig, register_arch


@register_arch("nemotron-4-340b")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="nemotron-4-340b",
        family="dense",
        num_layers=96,
        d_model=18432,
        n_heads=96,
        n_kv_heads=8,
        d_ff=73728,
        vocab_size=256000,
        activation="squared_relu",
        citation="arXiv:2402.16819",
    )
