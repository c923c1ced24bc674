"""Serving layer: ``serve_step.greedy_generate`` (LM prefill + greedy decode)."""
from .serve_step import greedy_generate  # noqa: F401
