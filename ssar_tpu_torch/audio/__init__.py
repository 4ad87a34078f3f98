"""Audio DSP and the 59-dim feature stack."""
