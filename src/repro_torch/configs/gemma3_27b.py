"""gemma3-27b [dense] — 5:1 local:global attention, 128k context.

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144.
[hf:google/gemma-3-1b-pt; unverified]
Mostly-local attention (window 1024) with 1-in-6 global layers; runs
long_500k with the global-layer KV cache length-sharded over `data`.
Pattern padded to 62 = 10*6 + 2 (trailing local layers).
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_ff=21504,
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
