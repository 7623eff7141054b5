"""Model configuration schema (port of ``repro.configs.base``).

The fields are the reference's, with torch dtypes, restricted to what the
ported paths read: paged serving and full-sequence training (attention
implementation and chunk, remat policy).  The MoE, SSM, hybrid and
frontend fields come with the model-zoo slice (ROADMAP queue 1 item 7);
the reference's deprecated ``sc_mode`` alias is not carried over.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense (this slice); moe | ssm | hybrid come later
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
    # SC multiplication substrate: a backend of repro_torch.sc
    sc_backend: str = "exact"
    sc_nbit: int = 1024
    # dtypes
    param_dtype: Any = torch.bfloat16
    act_dtype: Any = torch.bfloat16
    # remat policy per layer in training: none | full
    remat: str = "full"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // max(self.n_heads, 1)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


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
