"""paper-sc: the paper's own evaluation config lifted to an LM.

A compact dense LM whose every matmul runs through the SOT-MRAM SC engine
(moment-matched mode, nbit=1024 = 2^10 stochastic bits for 10-bit
operands, the paper's §V setup).  Port of ``repro.configs.paper_sc``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paper-sc",
    family="dense",
    n_layers=4,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=1024,
    vocab=2048,
    sc_backend="moment",
    sc_nbit=1024,
    attn_impl="full",
    remat="none",
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, d_ff=128, vocab=256)
