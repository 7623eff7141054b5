"""zamba2-7b [hybrid]: Mamba2 backbone + ONE weight-shared attention block.

81 "layers" = 54 Mamba2 layers + 27 invocations of the shared (MHA + MLP)
block (attn_every=2). d_model=3584, 32 heads (kv=32 — MHA), d_ff=14336,
vocab=32000, ssm_state=64 (d_inner=7168, headdim=64 -> 112 ssm heads).
Per-invocation LoRA deltas of the published model are omitted, as in
the reference.  [arXiv:2411.15242; unverified]
Port of ``repro.configs.zamba2_7b``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_headdim=64,
    attn_every=2,
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    n_layers=6,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    ssm_state=16,
    ssm_headdim=16,
    ssm_chunk=8,
    attn_impl="full",
    remat="none",
)
