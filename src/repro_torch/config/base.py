"""Config system for the repro framework.

Every selectable architecture is a ``ModelConfig`` registered under its
``--arch`` id.  Configs are plain frozen dataclasses so they hash, print,
and round-trip through ``replace`` cleanly.  ``reduced()`` derives the
CPU-smoke-test variant of any config (<=2 layers, d_model<=512,
<=4 experts) without changing the architecture family.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "audio", "hybrid", "ssm", "vlm", "cnn")
ACTIVATIONS = ("swiglu", "squared_relu", "gelu", "relu")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (transformer backbone or CNN)."""

    arch_id: str
    family: str                      # one of FAMILIES
    num_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    activation: str = "swiglu"
    head_dim: int = 0                # 0 -> d_model // n_heads
    # positional / attention
    rope_theta: float = 10_000.0
    sliding_window: int = 0          # 0 = full attention
    attn_logit_softcap: float = 0.0
    causal: bool = True              # False for encoder-only (audio)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False  # arctic: dense FFN residual beside MoE
    moe_capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_dense_ff: int = 0            # width of the dense residual FFN
    # SSM / recurrent
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    # xLSTM
    slstm_every: int = 0             # every k-th block is an sLSTM block
    proj_factor: float = 2.0
    # hybrid (hymba)
    hybrid_parallel: bool = False    # attention and SSM heads in parallel
    # modality frontend stubs
    frontend: str = "none"           # "none" | "audio_frames" | "vq_patches"
    image_tokens: int = 1024         # chameleon VQ tokens per image
    # CNN (paper's own models)
    cnn_channels: Tuple[int, ...] = ()
    cnn_fc: Tuple[int, ...] = ()
    input_hw: Tuple[int, int, int] = (28, 28, 1)
    n_classes: int = 10
    resnet: bool = False
    # numerics
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    citation: str = ""

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {self.activation!r}")
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads and self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"{self.arch_id}: n_heads={self.n_heads} not divisible by "
                f"n_kv_heads={self.n_kv_heads}")

    # -- derived sizes ------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_encoder_only(self) -> bool:
        return self.family == "audio"

    @property
    def subquadratic(self) -> bool:
        """True if decode over very long contexts is O(window) or O(1)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        if self.family == "cnn":
            return _cnn_param_count(self)
        d, L = self.d_model, self.num_layers
        n = self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                  # lm head
        per = 0
        if self.family != "ssm":                      # attention present
            per += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.family == "hybrid":                   # parallel ssm heads
            per += _ssm_params(self)
        if self.family == "ssm":
            per += _xlstm_params(self)
        if self.family == "moe":
            ff3 = 3 if self.activation == "swiglu" else 2
            per += self.n_experts * ff3 * d * self.d_ff + d * self.n_experts
            if self.moe_dense_residual:
                per += ff3 * d * (self.moe_dense_ff or self.d_ff)
        elif self.d_ff:
            ff3 = 3 if self.activation == "swiglu" else 2
            per += ff3 * d * self.d_ff
        per += 2 * d                                   # two RMSNorm scales
        return n + L * per

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.num_layers
        ff3 = 3 if self.activation == "swiglu" else 2
        inactive = L * (self.n_experts - self.top_k) * ff3 * d * self.d_ff
        return self.param_count() - inactive

    def reduced(self) -> "ModelConfig":
        """Reduced variant for CPU smoke tests (same family/topology)."""
        if self.family == "cnn":
            return dataclasses.replace(
                self, arch_id=self.arch_id + "-reduced",
                cnn_channels=tuple(min(c, 8) for c in self.cnn_channels),
                cnn_fc=tuple(min(c, 32) for c in self.cnn_fc[:-1]) + (self.cnn_fc[-1],),
            )
        n_heads = min(self.n_heads, 4)
        ratio = max(1, self.n_heads // max(1, self.n_kv_heads))
        n_kv = max(1, n_heads // min(ratio, n_heads))
        d_model = min(self.d_model, 256)
        head_dim = d_model // n_heads
        return dataclasses.replace(
            self,
            arch_id=self.arch_id + "-reduced",
            num_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            moe_dense_ff=min(self.moe_dense_ff, 256) if self.moe_dense_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            image_tokens=16,
        )


def _ssm_params(cfg: ModelConfig) -> int:
    d_in = cfg.ssm_expand * cfg.d_model
    return (cfg.d_model * 2 * d_in + d_in * cfg.ssm_conv
            + d_in * (2 * cfg.ssm_state + 1) + d_in  # x->B,C,dt ; A per chan
            + d_in * cfg.d_model)

def _xlstm_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    d_in = int(cfg.proj_factor * d)
    # mLSTM-ish block: up/gate proj, qkv, i/f gates, out
    return 2 * d * d_in + 3 * d_in * d_in // max(1, cfg.n_heads) + 2 * d_in + d_in * d

def _cnn_param_count(cfg: ModelConfig) -> int:
    h, w, c_in = cfg.input_hw
    n = 0
    c = c_in
    for ch in cfg.cnn_channels:
        n += 3 * 3 * c * ch + ch
        c = ch
    flat = (h // (2 ** len(cfg.cnn_channels))) * (w // (2 ** len(cfg.cnn_channels))) * c
    dims = (flat,) + cfg.cnn_fc
    for a, b in zip(dims[:-1], dims[1:]):
        n += a * b + b
    return n


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# FL / training / mesh configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FLConfig:
    """FedDCT + experiment hyper-parameters (paper §5.1 defaults)."""

    n_clients: int = 50
    n_tiers: int = 5                 # M
    tau: int = 5                     # clients selected per tier
    beta: float = 1.2                # timeout tolerance
    kappa: int = 1                   # evaluation rounds
    omega: float = 30.0              # max timeout threshold (s)
    rounds: int = 200                # N
    local_epochs: int = 1
    batch_size: int = 10
    lr: float = 0.001
    optimizer: str = "adam"
    method: str = "feddct"           # feddct|fedavg|tifl|fedasync
    # wireless model
    tier_delay_means: Tuple[float, ...] = (5.0, 10.0, 15.0, 20.0, 25.0)
    delay_std: float = 2.0
    mu: float = 0.0                  # failure probability
    failure_delay: Tuple[float, float] = (30.0, 60.0)
    # data heterogeneity
    primary_frac: float = 0.7        # "#" in the paper; 0 => iid
    seed: int = 0
    # fedasync
    async_alpha: float = 0.6
    async_staleness: str = "poly"    # poly | constant
    async_a: float = 0.5
    target_accuracy: float = 0.0     # 0 = run all rounds


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axes if a in ("pod", "data"))

    @property
    def model_axis(self) -> str:
        return "model"


@dataclass(frozen=True)
class TrainConfig:
    dtype: str = "bfloat16"          # activations/params dtype for lowering
    optimizer: str = "adamw"
    lr: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    remat: bool = True
    scan_layers: bool = True
    fsdp: bool = True                # shard params over the data axis too
    seed: int = 0
    # beyond-paper perf knobs (hillclimbed in EXPERIMENTS.md §Perf)
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    moe_group_tokens: int = 4096
    context_parallel: str = "auto"   # "never" = paper-faithful baseline
    seq_parallel: bool = False       # megatron-style sequence parallelism
    long_ctx_swa: bool = True        # SWA override for long_500k
    decode_headdim_shard: bool = True
    parallelism: str = "tp_fsdp"     # "fsdp_only" = pure ZeRO-3 data par.
    remat_policy: str = "full"       # "dots" = save matmul outputs only


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register_arch(arch_id: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def get_arch(arch_id: str) -> ModelConfig:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def list_archs():
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False

def _ensure_loaded():
    global _LOADED
    if not _LOADED:
        import repro_torch.configs  # noqa: F401  (registers everything)
        _LOADED = True
