"""Pallas GPU kernels (Triton route) for the channel-synthesis hot path."""
