"""whisper-large-v3 [audio] — encoder-decoder backbone; conv frontend STUB.

32L(enc)+32L(dec) d_model=1280 20H d_ff=5120 vocab=51866. [arXiv:2212.04356]
input_specs() provides precomputed frame embeddings (post-conv), per the
assignment. Decoder runs decode shapes; full attention -> long_500k skipped.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,            # decoder layers
    encoder_layers=32,
    encoder_frames=1500,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    act="gelu",
    rope_theta=0.0,         # learned positions, no RoPE
    sub_quadratic=False,
))
