"""Atomic, resumable, optionally asynchronous checkpoints."""
