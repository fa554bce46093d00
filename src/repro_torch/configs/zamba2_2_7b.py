"""zamba2-2.7b: 54 Mamba2 layers d=2560 (state 64, head 64) + one SHARED
attention block (32H kv=32, head 80; mlp ff=10240) applied every 6 layers;
vocab=32000.  [arXiv:2411.15242]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_head=80,
    d_ff=10240, vocab=32000,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    attn_every=6, tie_embeddings=True,
)

SMOKE = CONFIG.scaled(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_head=16, d_ff=128,
    vocab=128, ssm_state=16, ssm_head_dim=8, ssm_chunk=8, attn_every=2,
    param_dtype="float32", dtype="float32",
)
