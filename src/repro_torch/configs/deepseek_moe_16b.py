"""deepseek-moe-16b [moe] — fine-grained experts, 2 shared + 64 routed top-6.

28L d_model=2048 16H (kv=16) expert d_ff=1408 vocab=102400.
[arXiv:2401.06066; hf]  Layer 0 is a dense FFN (d_ff=10944).
Full attention -> long_500k skipped.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    n_experts=64,
    experts_per_token=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    n_dense_layers=1,
    dense_d_ff=10944,
    sub_quadratic=False,
))
