"""Frozen copies of the port's DSP, music-information and patch modules (plain
versions only: the sliding median runs its plain PyTorch form on every device)."""
