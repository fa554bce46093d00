"""qwen3-14b: 40L d=5120 40H (GQA kv=8, head 128) ff=17408 vocab=151936,
qk_norm.  [hf:Qwen/Qwen3-14B family]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=17408, vocab=151936, qk_norm=True, rope_theta=1000000.0,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
    vocab=128, param_dtype="float32", dtype="float32",
)
