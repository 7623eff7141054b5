"""qwen3-14b [dense]: GQA + qk-norm, explicit head_dim=128.

40L, d_model=5120, 40 heads (GQA kv=8), d_ff=17408 (SwiGLU), vocab=151936.
[hf:Qwen/Qwen3-8B; hf]
Port of ``repro.configs.qwen3_14b``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab=151936,
    qk_norm=True,
    head_dim=128,
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    head_dim=16,
    attn_impl="full",
    remat="none",
)
