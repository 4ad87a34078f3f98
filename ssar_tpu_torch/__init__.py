"""PyTorch / CUDA port of ``ssar_tpu`` for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (``ops/``, ``audio/``, ``models/``,
``gan/``, ``generate/``, ``train/``, ``metrics/``, ``video/``, ``parallel/``)
so each module's counterpart is found by name.  ``parallel`` exports the JAX
package's ``get_mesh``, ``make_mesh``, ``data_sharding``, ``shard_batch``,
``replicate``, ``shard_generator_params`` and ``synthesize_tp`` over
``torch.distributed``; one process with no process group is a world of one.
The JAX package is the reference this port is held against; the port
imports none of it.  Entry points run on the CUDA device unless the caller
passes ``device="cpu"``; they raise when no CUDA device is present rather
than fall back.  ``csrc/`` holds the hand-written CUDA kernels, built from
source at first use (``ops/_build.py``).
"""
