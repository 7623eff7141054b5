"""moonshot-v1-16b-a3b [moe]: Moonlight (kimi) 16B-A3B MoE.

48L, d_model=2048, 16 heads (kv=16), expert d_ff=1408, vocab=163840,
64 experts top-6 (deepseek-v3-style fine-grained experts), untied.
[hf:moonshotai/Moonlight-16B-A3B; hf]
Port of ``repro.configs.moonshot_v1_16b_a3b``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163840,
    n_experts=64,
    top_k=6,
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab=256,
    n_experts=8,
    top_k=2,
    attn_impl="full",
    remat="none",
)
