"""llama4-maverick-400b-a17b [moe]: 400B total / 17B active.

48L, d_model=5120, 40 heads (GQA kv=8), expert d_ff=8192, vocab=202048,
128 experts top-1 + one always-on shared expert.  Text backbone only;
iRoPE attention chunking is not modeled (full attention).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
Port of ``repro.configs.llama4_maverick_400b_a17b``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    n_experts=128,
    top_k=1,
    shared_expert=True,
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab=256,
    n_experts=8,
    top_k=1,
    attn_impl="full",
    remat="none",
)
