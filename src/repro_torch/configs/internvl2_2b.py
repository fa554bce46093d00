"""internvl2-2b: InternLM2-1.8B-style LM backbone (24L d=2048 16H GQA kv=8
ff=8192 vocab=92553) + InternViT frontend STUBBED (the caller provides
patch embeddings prepended to the token stream).  [arXiv:2404.16821]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab=92553, n_patches=256, rope_theta=1000000.0,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
    vocab=128, n_patches=4, param_dtype="float32", dtype="float32",
)
