"""qwen2-7b: 28L d=3584 28H (GQA kv=4, head 128) ff=18944 vocab=152064,
QKV bias.  [arXiv:2407.10671]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_head=128,
    d_ff=18944, vocab=152064, qkv_bias=True, rope_theta=1000000.0,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
    vocab=128, param_dtype="float32", dtype="float32",
)
