"""The port's multichip dry run (``parallel/dryrun.py``, the counterpart of
``__graft_entry__.py:dryrun_multichip``) at small shapes: in one process on
the CPU (n = 1) and on gloo process groups of 2 and 4 CPU ranks, (1 x 2) and
(2 x 2) meshes.  The function raises unless its sharded trajectory is within
rtol 5e-4 of the one-device trajectory and falls, and the channel-parallel
frames are finite; the test reads its result and its summary line.
"""
import numpy as np
import pytest

from ssar_tpu_torch.parallel.dryrun import dryrun_multichip
from torch_parity import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_multichip_at_small_shapes(n, capsys):
    tp = 2 if n % 2 == 0 else 1
    dp = n // tp
    out = dryrun_multichip(n, batch=4 * dp, frames=16, hidden=8, num_layers=2, resolution=32, device="cpu")
    assert out["mesh"] == (dp, tp) and len(out["losses"]) == 6
    assert out["losses"][-1] < out["losses"][0]
    np.testing.assert_allclose(out["losses"], out["reference"], rtol=5e-4)
    assert out["tp_synth"] == (2 * dp, 32, 32, 3)
    assert f"dryrun_multichip({n}): mesh=({dp}x{tp})" in capsys.readouterr().out
