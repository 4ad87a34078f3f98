"""Benchmark of the PyTorch / CUDA port (``ssar_tpu_torch``) on one H100: see README.md."""
