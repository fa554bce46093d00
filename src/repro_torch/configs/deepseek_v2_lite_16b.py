"""deepseek-v2-lite-16b: 27L d=2048 16H MLA(kv_lora=512) expert-ff=1408
vocab=102400, 2 shared + 64 routed top-6, layer0 dense ff=10944.
[arXiv:2405.04434]  (assignment's `64e top-6` line used; see DESIGN.md §8.)"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400, n_experts=64, top_k=6, n_shared_experts=2,
    first_dense_ff=10944,
    mla=True, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    rope_theta=10000.0,
)

SMOKE = CONFIG.scaled(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=48, vocab=128,
    n_experts=4, top_k=2, n_shared_experts=1, first_dense_ff=96,
    kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    param_dtype="float32", dtype="float32",
)
