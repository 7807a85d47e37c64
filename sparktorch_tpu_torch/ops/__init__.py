"""Attention ops and the hand-written Hopper kernels (``csrc/``)."""
