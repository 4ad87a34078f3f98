"""Audio-reactivity metrics (only ``rhythmic.percentile_clip`` so far)."""
