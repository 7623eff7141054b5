"""musicgen-large [audio]: decoder-only transformer over EnCodec tokens.

48L, d_model=2048, 32 heads (MHA — kv=32), d_ff=8192 (classic GELU MLP),
vocab=2048 (one EnCodec codebook; the interleaving pattern is
frontend-side).  The EnCodec frontend is a STUB: inputs arrive as
precomputed frame embeddings (``models/frontend.py``).
[arXiv:2306.05284; hf]
Port of ``repro.configs.musicgen_large``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    mlp_variant="gelu",
    frontend="embeddings",
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=128,
    attn_impl="full",
    remat="none",
)
