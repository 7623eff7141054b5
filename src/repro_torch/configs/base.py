"""Model configuration schema (port of ``repro.configs.base``).

The fields are the reference's, with torch dtypes, restricted to what the
ported paths read: paged and fixed-slot serving and full-sequence
training of every family.  The reference's deprecated ``sc_mode`` alias
is not carried over.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | audio | moe | vlm | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # attention features
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    mlp_variant: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = True  # False -> separate unembedding matrix
    attn_impl: str = "blockwise"  # blockwise | full (training path)
    attn_chunk: int = 1024  # kv/q chunk for blockwise attention
    # paged decode attention path (kernels/paged_attention.py):
    # unfused (gather + chunk_decode_attention) | fused (one CUDA kernel,
    # same math) | fused_sc (fused, SC-sampled QK^T; needs rng keys)
    paged_attn: str = "unfused"
    # MoE
    n_experts: int = 0
    top_k: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # hybrid (zamba2): one SHARED attn+MLP block every `attn_every` ssm layers
    attn_every: int = 0
    # SC multiplication substrate: a backend of repro_torch.sc
    sc_backend: str = "exact"
    sc_nbit: int = 1024
    # dtypes
    param_dtype: Any = torch.bfloat16
    act_dtype: Any = torch.bfloat16
    # input frontend: "tokens" (ids) or "embeddings" (precomputed frame /
    # patch embeddings through models/frontend.py's projection)
    frontend: str = "tokens"
    # remat policy per layer in training: none | full
    remat: str = "full"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


# The four production cells of the dry-run (``launch/dryrun.py``).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "musicgen-large",
    "moonshot-v1-16b-a3b",
    "llama4-maverick-400b-a17b",
    "chameleon-34b",
    "starcoder2-15b",
    "qwen2-0.5b",
    "qwen3-14b",
    "yi-6b",
    "zamba2-7b",
    "mamba2-370m",
    "paper-sc",
]


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_")
    )
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_")
    )
    return mod.SMOKE


def supported_shapes(cfg: ModelConfig) -> list[str]:
    """Which of the four assigned shapes an architecture runs:
    ``long_500k`` needs sub-quadratic attention, so only the SSM and
    hybrid families run it."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.family in ("ssm", "hybrid"):
        out.append("long_500k")
    return out
