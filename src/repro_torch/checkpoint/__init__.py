"""Checkpoints of the port's training state (twin of ``repro.checkpoint``):
``store.save`` / ``store.restore`` / ``store.verify``."""
