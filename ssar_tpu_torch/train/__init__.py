"""Training: losses, data pipeline and the trainer (``python -m ssar_tpu_torch.train.train``)."""
