"""qwen1.5-4b [dense] — QKV bias. 40L d_model=2560 20H d_ff=6912 vocab=151936.

[hf:Qwen/Qwen1.5-0.5B; hf]  Full attention -> long_500k skipped.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    sub_quadratic=False,
))
