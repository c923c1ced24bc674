"""Fault injection, supervision of training loops, the process mesh and
the multi-process plane (``repro.launch``'s counterpart)."""
