"""The paper's pipeline entry points on the port, each a module with a CLI.

Counterparts of the repository's ``scripts/`` entry points, which run the JAX
package: ``make_record_dataset`` (the record corpus and its windowed cache),
``train_calibration_g`` (the in-environment calibration G and D),
``ood_absolute`` (FID / KID / PRDC through the calibration D) and
``run_study`` (the compare-big-three study).  The grid is
``ssar_tpu_torch.experiments``.  Each runs on the CUDA device unless
``--device`` says otherwise.  ``scripts/collect_grid.py`` and
``scripts/collect_study.py`` read their output as they read the JAX runs'.
"""
