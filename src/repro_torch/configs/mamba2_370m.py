"""mamba2-370m [ssm]: pure SSD (state-space duality), attention-free.

48L, d_model=1024, ssm_state=128, vocab=50280 (d_inner=2048, headdim=64 ->
32 ssm heads). d_ff=0 — the Mamba2 block IS the layer.  The SC MUL
substrate applies to all projections.  [arXiv:2405.21060; unverified]
Port of ``repro.configs.mamba2_370m``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_headdim=64,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=64,
    vocab=256,
    ssm_state=16,
    ssm_headdim=16,
    ssm_chunk=8,
    remat="none",
)
