"""The plain reference the benchmark holds the port's outputs against.

Plain PyTorch in float32 with TF32 off (``synthesis.py``, ``reactor.py``) and
frozen copies of the port's DSP and patch modules (``frozen/``).  Nothing
here imports the port: weights, palettes and noise are worked out again from
the seeds the benchmark hands both sides.
"""
