"""Tensor ops: median (CUDA kernel + plain version), filters, quantiles, upfirdn."""
