"""minitron-8b: 32L d=4096 32H (GQA kv=8) ff=16384 vocab=256000; pruned
Nemotron-4 -> squared-ReLU MLP, partial rotary 0.5.  [arXiv:2407.14679]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=16384, vocab=256000, mlp="relu2", rotary_pct=0.5,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
    vocab=128, param_dtype="float32", dtype="float32",
)
