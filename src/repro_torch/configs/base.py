"""Model/config schema and architecture registry (the port's own copy).

Field for field the reference's ``repro.configs.base``: the port keeps its
own copy so that it imports nothing of the JAX package.  Each architecture
the port serves has its own ``configs/<id>.py`` exposing ``CONFIG`` (the
full-scale config) and ``SMOKE_CONFIG`` (same family, reduced to CPU
scale): :data:`PORTED_ARCHS`; :func:`get_config` and
:func:`get_smoke_config` raise for the others, naming ROADMAP A.11.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                    # 0 -> d_model // num_heads
    mlp_act: str = "swiglu"              # swiglu | gelu | relu2
    qkv_bias: bool = False
    use_rope: bool = True
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"                # rmsnorm | layernorm
    tie_embeddings: bool = False
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    dense_residual: bool = False         # arctic: parallel dense FFN branch
    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    # Encoder-decoder (whisper): encoder depth; num_layers = decoder depth
    encoder_layers: int = 0
    # VLM stub frontend: number of image patch embeddings prepended
    num_patches: int = 0
    # Long-context behaviour
    sliding_window: int = 0              # 0 = global attention
    subquadratic: bool = False           # may run long_500k
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # parallelism policy (the reference's parallel/sharding.py; one card
    # here, so the port reads none of these)
    attn_tp: bool = True                 # shard attention heads over `model`
    remat: bool = True
    attn_impl: str = "auto"              # auto | dense (smoke/debug)
    seq_parallel: bool = False           # SP sharding hints on activations
    train_microbatches: int = 1          # grad-accumulation splits
    use_weight_hints: bool = True       # ZeRO-3 weight-gather use hints
    serve_param_fsdp: bool = True        # False: replicate params at decode
    serve_tp: bool = True                # False: no TP at decode (small models)
    moe_batch_group_decode: bool = True  # S=1: dispatch across the batch

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def block_type(self) -> str:
        if self.family == "ssm":
            return "rwkv"
        if self.family == "hybrid":
            return "hybrid"
        return "attn"

    @property
    def num_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.hd
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
            + self.num_heads * hd * d
        if self.mlp_act == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.num_experts:
            mlp_total = self.num_experts * mlp + d * self.num_experts
            if self.dense_residual:
                mlp_total += mlp
        else:
            mlp_total = mlp
        per_layer = attn + mlp_total + 2 * d
        if self.block_type == "rwkv":
            per_layer = 4 * d * d + 3 * d * f // 2 + 6 * d  # rwkv-ish
        emb = V * d * (1 if self.tie_embeddings else 2)
        enc = self.encoder_layers * (attn + mlp + 2 * d)
        return per_layer * self.num_layers + emb + enc

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

ARCH_REGISTRY = (
    "nemotron_4_340b",
    "qwen1_5_110b",
    "starcoder2_7b",
    "glm4_9b",
    "whisper_medium",
    "hymba_1_5b",
    "granite_moe_1b_a400m",
    "arctic_480b",
    "pixtral_12b",
    "rwkv6_1_6b",
)


#: Architectures of ``ARCH_REGISTRY`` with a config file in the port.
PORTED_ARCHS = ("rwkv6_1_6b", "glm4_9b", "starcoder2_7b",
                "granite_moe_1b_a400m", "arctic_480b", "pixtral_12b",
                "whisper_medium", "hymba_1_5b")


def _config_module(name: str):
    if name not in ARCH_REGISTRY:
        raise KeyError(f"unknown architecture {name!r}; known: "
                       f"{', '.join(ARCH_REGISTRY)}")
    if name not in PORTED_ARCHS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet (ROADMAP A.11); the "
            f"port has configs for {', '.join(PORTED_ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str) -> ModelConfig:
    return _config_module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _config_module(name).SMOKE_CONFIG
