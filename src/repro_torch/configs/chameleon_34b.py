"""chameleon-34b [vlm]: early-fusion mixed-modal transformer.

48L, d_model=8192, 64 heads (GQA kv=8), d_ff=22016 (SwiGLU), vocab=65536
(text and VQ-GAN image codes in one shared vocabulary: image tokens are
ordinary ids, so the backbone is the dense one).  qk-norm.
[arXiv:2405.09818; unverified]
Port of ``repro.configs.chameleon_34b``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65536,
    qk_norm=True,
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
