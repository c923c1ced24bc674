"""smollm-135m [dense] — llama-arch small. 30L d_model=576 9H (kv=3) d_ff=1536.

[hf:HuggingFaceTB/SmolLM-135M; hf]  Full attention -> long_500k skipped.
Also the ~100M-class model used by examples/lm_pretrain.py.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    tie_embeddings=True,
    sub_quadratic=False,
))
