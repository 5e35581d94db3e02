"""Optimizers (AdamW), counterpart of ``repro/optim``."""
