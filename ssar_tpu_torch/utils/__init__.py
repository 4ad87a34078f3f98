"""Device resolution and numeric-precision helpers.

``ssar_tpu/utils/__init__.py`` exports ``on_tpu`` and ``pallas_interpret``
from its ``platform.py``, which chooses Pallas's interpret mode on a host
without a TPU.  The port has no counterpart: a kernel wrapper takes its plain
version for a CPU tensor (``ops/__init__.py``), and ``device.resolve_device``
picks the device.
"""
