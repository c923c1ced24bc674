"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.

48L d_model=1536 d_ff=0 vocab=50280, ssm_state=128. [arXiv:2405.21060]
Sub-quadratic: runs long_500k.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,            # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,               # mamba2 blocks have no separate MLP
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    tie_embeddings=True,
    sub_quadratic=True,
))
