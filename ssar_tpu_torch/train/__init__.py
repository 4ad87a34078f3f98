"""Training: losses, data pipeline and the trainer (``python -m ssar_tpu_torch.train.train``)."""
from .data import WindowDataset, overlapping_slices, prefetch, synthetic_dataset, train_val_split
from .losses import (
    audio_reactive_loss,
    normalize_gradients,
    orthogonal_procrustes_distance,
    supervised_loss,
)
