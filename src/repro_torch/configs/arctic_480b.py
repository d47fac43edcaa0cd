"""Snowflake Arctic 480B — 128-expert top-2 MoE + dense residual
[hf:Snowflake/snowflake-arctic-base]."""

from repro_torch.config.base import ModelConfig, register_arch


@register_arch("arctic-480b")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="arctic-480b",
        family="moe",
        num_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=4864,
        vocab_size=32000,
        activation="swiglu",
        n_experts=128,
        top_k=2,
        moe_dense_residual=True,   # dense FFN residual beside the MoE
        moe_dense_ff=4864,
        citation="hf:Snowflake/snowflake-arctic-base",
    )
