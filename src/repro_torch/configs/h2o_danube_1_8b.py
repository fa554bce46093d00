"""h2o-danube-1.8b: 24L d=2560 32H (GQA kv=8, head 80) ff=6912 vocab=32000,
llama+mistral mix with sliding-window attention.  [arXiv:2401.16818]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, d_head=80,
    d_ff=6912, vocab=32000, window=4096, rope_theta=10000.0,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
    vocab=128, window=8, param_dtype="float32", dtype="float32",
)
