"""Fault injection and supervision of training loops (``repro.launch``'s counterpart)."""
