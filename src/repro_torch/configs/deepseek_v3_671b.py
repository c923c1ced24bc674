"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8.

61L d_model=7168 128H d_ff(expert)=2048 vocab=129280. [arXiv:2412.19437; hf]
MLA: q_lora 1536, kv_lora 512, rope 64, nope 128, v 128. First 3 layers
dense (d_ff=18432). MTP head omitted (DESIGN.md §Arch-applicability).
MLA cache = 576 B/token/layer -> sub-quadratic memory; runs long_500k.
bf16 optimizer moments (fp32 would overflow the 16 GB/chip budget).
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,
    vocab_size=129280,
    n_experts=256,
    experts_per_token=8,
    n_shared_experts=1,
    moe_d_ff=2048,
    n_dense_layers=3,
    dense_d_ff=18432,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    param_dtype="bfloat16",        # fp32 params = 2.7 TB: 10.5 GB/chip on 256
    moment_dtype="bfloat16",
    factored_second_moment=True,   # full AdamW v = 1.34 TB: cannot fit one pod
    sub_quadratic=True,
))
