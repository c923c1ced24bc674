"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests must see ONE
device; only tests that need a mesh spawn host devices via a subprocess
or the dedicated mesh fixtures below (which use the real single device
count and skip if unavailable)."""
import dataclasses

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one (run with -m cuda on the card)"
    )


@pytest.fixture(scope="session")
def class_data():
    from repro.data.tabular import make_classification, train_test_split

    x, y = make_classification(
        n_samples=3000, n_features=48, n_classes=4, n_informative=10,
        label_noise=0.05, seed=7,
    )
    return train_test_split(x, y, 0.25, 0)


def reduce_cfg(cfg, **over):
    """Tiny same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=min(cfg.n_layers, 4) if not cfg.pattern else 2 * len(cfg.pattern),
        d_model=128, n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=256 if cfg.d_ff else 0, vocab_size=512, head_dim=32,
        encoder_layers=2 if cfg.encoder_layers else 0, encoder_frames=16,
        vision_tokens=8 if cfg.vision_tokens else 0,
        cross_attn_every=2 if cfg.cross_attn_every else 0,
        meta_tokens=4 if cfg.meta_tokens else 0,
        local_window=8 if cfg.local_window else 0,
        n_experts=8 if cfg.n_experts else 0,
        experts_per_token=2 if cfg.n_experts else 0,
        moe_d_ff=64 if cfg.n_experts else 0,
        n_dense_layers=1 if cfg.n_dense_layers else 0,
        dense_d_ff=256 if cfg.dense_d_ff else 0,
        q_lora_rank=32 if cfg.use_mla else 0,
        kv_lora_rank=16 if cfg.use_mla else 0,
        qk_rope_dim=16 if cfg.use_mla else 0,
        qk_nope_dim=16 if cfg.use_mla else 0,
        v_head_dim=32 if cfg.use_mla else 0,
        ssm_state=16 if cfg.ssm_state else 0, ssm_head_dim=32,
        compute_dtype="float32", remat="none", ep_mode="gspmd",
        capacity_factor=8.0,
    )
    kw.update(over)
    return dataclasses.replace(cfg, **kw)
