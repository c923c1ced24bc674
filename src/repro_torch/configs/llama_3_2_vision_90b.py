"""llama-3.2-vision-90b [vlm] — cross-attn image layers.

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
Modality frontend is a STUB: input_specs() provides precomputed patch
embeddings (vision_tokens x d_model); every 5th layer cross-attends.
Full attention -> long_500k is skipped (see DESIGN.md §Arch-applicability).
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_every=5,
    vision_tokens=1024,
    rope_theta=500_000.0,
    moment_dtype="bfloat16",
    sub_quadratic=False,
))
