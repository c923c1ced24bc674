"""hymba-1.5b [hybrid] — parallel attention + mamba heads in each block.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
[arXiv:2411.13676; hf]
Sliding-window attention on local layers + meta tokens; sub-quadratic.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    local_window=1024,
    meta_tokens=64,
    sub_quadratic=True,
))
