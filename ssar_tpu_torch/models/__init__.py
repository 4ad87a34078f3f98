"""Reactor models (features -> W+ latents + noise)."""
