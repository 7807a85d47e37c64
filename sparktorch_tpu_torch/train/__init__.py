"""Trainers (ported so far: synchronous training on one GPU)."""
