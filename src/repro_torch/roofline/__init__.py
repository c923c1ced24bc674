"""Per-device FLOP, byte, collective and memory counts of a step on a mesh
(``repro.roofline``'s counterpart)."""
