"""Model / run configuration system.

A copy of the reference's ``repro/configs/base.py`` (pure Python), so the
port never imports the JAX package; only the registry's import differs.
Every architecture is expressed as a ``ModelConfig`` built from a
repeating ``pattern`` of ``LayerSpec`` units.  The full stack is
``pattern * n_units`` layers; the port runs it as a Python loop over the
units (the reference scans over a stacked unit axis).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

# ---------------------------------------------------------------------------
# Layer specs
# ---------------------------------------------------------------------------

# mixer kinds
ATTN = "attn"                # causal (or bidirectional) GQA self-attention
ATTN_CHUNKED = "attn_chunked"  # local/chunked attention (window = attn_window)
CROSS_ATTN = "cross_attn"    # cross-attention to media embeddings (vlm)
MAMBA2 = "mamba2"            # SSD state-space mixer

# mlp kinds
DENSE = "dense"
MOE = "moe"
NONE = "none"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = ATTN
    mlp: str = DENSE


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_expert: int = 1024          # per-expert ffn hidden dim
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    n_shared_experts: int = 0
    d_shared: int = 0             # hidden dim of the shared expert (0 = none)
    # dtype of the token payload shipped through the EP all_to_all
    # ("float8_e4m3fn" halves dispatch bytes, DeepSeek-V3 style; the
    # combine return path stays in the activation dtype)
    dispatch_dtype: str = ""      # "" = activation dtype


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64            # SSD head dim (P)
    chunk: int = 256              # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"         # dense | moe | hybrid | ssm | vlm | audio

    # dimensions
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 0             # 0 -> d_model // n_heads
    d_ff: int = 2048
    vocab_size: int = 32000

    # stack structure: layers = pattern * n_units
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    n_units: int = 4

    # attention details
    causal: bool = True           # False for encoder-only (hubert)
    qk_norm: bool = False         # qwen3
    attn_bias: bool = False       # qwen1.5 QKV bias
    attn_window: int = 0          # window for ATTN_CHUNKED layers
    rope_theta: float = 10000.0
    logit_softcap: float = 0.0

    # norms / embeddings
    norm: str = "rmsnorm"         # rmsnorm | layernorm | nonparam_ln
    tie_embeddings: bool = False
    embedding_multiplier: float = 1.0
    mlp_gated: bool = True        # SwiGLU (3 mats) vs GELU (2 mats, hubert)

    # sub-configs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # process the MoE dispatch in N sequence chunks (divides the peak
    # dispatch-buffer footprint by N at unchanged total a2a bytes)
    moe_seq_chunks: int = 1

    # sequence parallelism: residual stream sharded over the TP axis on the
    # sequence dim between blocks (turns activation all-reduces into
    # all-gather + reduce-scatter pairs and shards norm/elementwise work)
    seq_parallel: bool = False

    # modality frontend stub (audio frames / vision patches)
    frontend: str = "none"        # none | audio_frames | vision_patches
    n_media_tokens: int = 0       # media tokens per sequence (vlm cross-attn)

    # training numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    opt_state_dtype: str = "float32"   # bf16 for the very largest archs
    remat: bool = True

    # distribution: "fsdp" shards params over the data axis (GSPMD baseline /
    # secure gather-RS); "replicated" keeps params DP-replicated (pure-TP
    # within pod) — the directly paper-shaped secure path (DESIGN §2.2)
    dp_mode: str = "fsdp"

    # serving
    decoder: bool = True          # False -> no decode shapes (encoder-only)

    # ----- derived -----
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.n_units

    def layer_specs(self) -> tuple[LayerSpec, ...]:
        return self.pattern * self.n_units

    # parameter counting (used by tests + roofline MODEL_FLOPS)
    def param_count(self) -> int:
        d, hd = self.d_model, self.hd
        n = 0
        # embeddings (+ untied head)
        n += self.vocab_size * d
        if not self.tie_embeddings:
            n += self.vocab_size * d
        per_norm = d if self.norm != "nonparam_ln" else 0
        n += per_norm  # final norm
        for spec in self.layer_specs():
            if spec.mixer in (ATTN, ATTN_CHUNKED, CROSS_ATTN):
                q = d * self.n_heads * hd
                kv = 2 * d * self.n_kv_heads * hd
                o = self.n_heads * hd * d
                n += q + kv + o + per_norm
                if self.attn_bias:
                    n += (self.n_heads + 2 * self.n_kv_heads) * hd
                if self.qk_norm:
                    n += 2 * hd
                if spec.mixer == CROSS_ATTN:
                    n += per_norm  # media norm
            elif spec.mixer == MAMBA2:
                s = self.ssm
                d_in = s.expand * d
                nh = d_in // s.head_dim
                n += d * (2 * d_in + 2 * s.d_state + nh)   # in_proj: z,x,B,C,dt
                n += s.d_conv * (d_in + 2 * s.d_state)     # conv over x,B,C
                n += nh * 2                                 # A_log, D
                n += d_in                                   # per-head dt bias folded + gate norm
                n += d_in * d                               # out_proj
                n += per_norm
            if spec.mlp == DENSE:
                n += (3 if self.mlp_gated else 2) * d * self.d_ff + per_norm
            elif spec.mlp == MOE:
                m = self.moe
                n += m.n_experts * 3 * d * m.d_expert + d * m.n_experts + per_norm
                if m.d_shared:
                    n += 3 * d * m.d_shared
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full = self.param_count()
        n_moe_layers = sum(1 for s in self.layer_specs() if s.mlp == MOE)
        inactive = n_moe_layers * (m.n_experts - m.top_k) * 3 * self.d_model * m.d_expert
        return full - inactive


# ---------------------------------------------------------------------------
# Input shapes (assigned to the LM pool)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_SMOKE_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str, full: Callable[[], ModelConfig],
             smoke: Callable[[], ModelConfig]) -> None:
    _REGISTRY[name] = full
    _SMOKE_REGISTRY[name] = smoke


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs.all  # noqa: F401  (populate registry)
    return _REGISTRY[name]()


def get_smoke_config(name: str) -> ModelConfig:
    import repro_torch.configs.all  # noqa: F401
    return _SMOKE_REGISTRY[name]()


def list_archs() -> list[str]:
    import repro_torch.configs.all  # noqa: F401
    return sorted(_REGISTRY)


def supported_shapes(cfg: ModelConfig) -> list[str]:
    """Which of the 4 assigned shapes apply to this arch (skip rules)."""
    out = ["train_4k", "prefill_32k"]
    if cfg.decoder:
        out.append("decode_32k")
        if is_subquadratic(cfg):
            out.append("long_500k")
    return out


def is_subquadratic(cfg: ModelConfig) -> bool:
    """True if no layer attends to unbounded full context (SSM / hybrid w/
    windowed global layers count as sub-quadratic for decode per DESIGN §4)."""
    specs = cfg.layer_specs()
    if all(s.mixer == MAMBA2 for s in specs):
        return True
    if any(s.mixer == MAMBA2 for s in specs):
        return True  # hybrid: attention layers exist but state-dominated (jamba)
    if any(s.mixer == ATTN_CHUNKED for s in specs):
        return True  # llama4-style chunked-local + sparse full layers
    return False
