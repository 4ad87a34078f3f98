"""Example patch files for ``generate.audioreactive.render_patch``.

Ports of six of the JAX package's ``examples/*_patch.py``, each covering a
part of the patch-file contract.  They are loaded by path
(``audioreactive.load_patch_module``), not imported as modules.
"""
