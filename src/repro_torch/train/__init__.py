"""Training step and loop, counterpart of ``repro/train``."""
