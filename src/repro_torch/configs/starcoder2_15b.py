"""starcoder2-15b [dense]: GQA + RoPE code model.

40L, d_model=6144, 48 heads (GQA kv=4), d_ff=24576 (classic GELU MLP),
vocab=49152.  [arXiv:2402.19173; hf]
Port of ``repro.configs.starcoder2_15b``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    mlp_variant="gelu",
    qkv_bias=True,
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    attn_impl="full",
    remat="none",
)
