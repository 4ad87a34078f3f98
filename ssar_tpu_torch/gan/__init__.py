"""StyleGAN2 synthesis, rendering and video output."""
