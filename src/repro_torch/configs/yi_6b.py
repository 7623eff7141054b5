"""yi-6b [dense]: llama-architecture GQA.

32L, d_model=4096, 32 heads (GQA kv=4), d_ff=11008 (SwiGLU), vocab=64000.
[arXiv:2403.04652; hf]
Port of ``repro.configs.yi_6b``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
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
