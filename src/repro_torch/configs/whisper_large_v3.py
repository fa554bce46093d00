"""whisper-large-v3 backbone: 32 enc + 32 dec layers, d=1280 20H (MHA)
ff=5120 vocab=51866, LayerNorm/GELU, learned decoder positions; conv audio
frontend STUBBED (frames come in as embeddings).  [arXiv:2212.04356]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=64, enc_layers=32, dec_layers=32,
    d_model=1280, n_heads=20, n_kv_heads=20, d_head=64,
    d_ff=5120, vocab=51866, norm="layernorm", mlp="gelu", use_rope=False,
    tie_embeddings=True,
)

SMOKE = CONFIG.scaled(
    n_layers=4, enc_layers=2, dec_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_head=16, d_ff=128, vocab=128,
    param_dtype="float32", dtype="float32",
)
