"""granite-moe-1b-a400m: 24L d=1024 16H (GQA kv=8) expert-ff=512 vocab=49155,
MoE 32 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_head=64,
    d_ff=512, vocab=49155, n_experts=32, top_k=8,
    tie_embeddings=True, rope_theta=10000.0,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=32,
    vocab=128, n_experts=4, top_k=2, param_dtype="float32", dtype="float32",
)
