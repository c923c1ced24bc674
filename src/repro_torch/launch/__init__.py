"""Fault injection, supervision of training loops and the process mesh
(``repro.launch``'s counterpart)."""
