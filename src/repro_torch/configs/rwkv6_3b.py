"""rwkv6-3b (Finch): 32L d=2560 attention-free (head 64), channel-mix
ff=8960, vocab=65536; data-dependent decay.  [arXiv:2404.05892]

The norms are ``rmsnorm``, as the JAX package's config has them (the
published Finch uses LayerNorm); the port mirrors the reference."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab=65536, rwkv_head_dim=64,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=8, d_ff=128, vocab=128,
    rwkv_head_dim=8, param_dtype="float32", dtype="float32",
)
