"""Registers the selectable architectures (``--arch <id>``): the CNN
family of the paper, and the LM configs of the dense, hybrid, MoE,
xLSTM, audio and VLM families (``llama3.2-1b``, ``granite-20b``,
``nemotron-4-340b``, ``phi4-mini-3.8b``, dense; ``hymba-1.5b``,
hybrid; ``mixtral-8x7b``, ``arctic-480b``, MoE; ``xlstm-350m``, ssm;
``hubert-xlarge``, audio, an encoder over frames; ``chameleon-34b``,
vlm, image tokens as ids of its vocabulary)."""

from repro_torch.configs import (  # noqa: F401
    arctic_480b,
    chameleon_34b,
    granite_20b,
    hubert_xlarge,
    hymba_1_5b,
    llama3_2_1b,
    mixtral_8x7b,
    nemotron_4_340b,
    phi4_mini_3_8b,
    xlstm_350m,
)
from repro_torch.configs import paper_models  # noqa: F401
from repro_torch.configs.shapes import INPUT_SHAPES  # noqa: F401
