"""gemma3-12b [dense] — 5:1 local:global attention, 128k context.

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144.
[hf:google/gemma-3-1b-pt; unverified]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15360,
    vocab_size=262144,
    pattern=("local", "local", "local", "local", "local", "global"),
    local_window=1024,
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    qk_norm=True,
    act="geglu",
    tie_embeddings=True,
    sub_quadratic=True,
))
