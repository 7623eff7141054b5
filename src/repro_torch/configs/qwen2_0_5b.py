"""qwen2-0.5b [dense]: GQA with QKV bias; tied embeddings.

24L, d_model=896, 14 heads (GQA kv=2), d_ff=4864 (SwiGLU), vocab=151936.
Small enough to train on the moment substrate.  [arXiv:2407.10671; hf]
Port of ``repro.configs.qwen2_0_5b``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151936,
    qkv_bias=True,
    tie_embeddings=True,
    attn_chunk=2048,
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
