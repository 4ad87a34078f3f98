"""One reader a per-layer metric: ``read(run) -> float | None``, None where the
run holds nothing for it to read (the metric is then left out of the line)."""
