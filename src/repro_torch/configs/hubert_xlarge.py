"""HuBERT X-Large — encoder-only audio transformer [arXiv:2106.07447].

Backbone only: the conv/mel frontend is a stub — ``input_specs`` feeds
precomputed frame embeddings of shape (batch, frames, d_model).
Vocab 504 = HuBERT's k-means target codebook size (masked-prediction head).
"""

from repro_torch.config.base import ModelConfig, register_arch


@register_arch("hubert-xlarge")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="hubert-xlarge",
        family="audio",
        num_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,           # full MHA (GQA kv=16)
        d_ff=5120,
        vocab_size=504,
        activation="gelu",
        causal=False,            # bidirectional encoder
        frontend="audio_frames",
        citation="arXiv:2106.07447",
    )
