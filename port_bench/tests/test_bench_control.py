"""The control (the reference one precision step below the configuration's:
TF32 features, a bfloat16 reactor, fp8 synthesis operands) has to come out
as not correct.

On the CPU at a small size the control's gaps stand well above the
program's; on the card (``-m cuda``) at the cell's own size, on three
seeds, the control fails the cell's limits while the program passes them."""
import pytest

from port_bench.calibrate import readings
from port_bench.compare import judge
from port_bench.harness import HERE, load_json

from .conftest import LONGFORM, PATCH, small


@pytest.mark.parametrize("workload", [LONGFORM, PATCH])
def test_control_stands_above_the_program_at_a_small_size(workload):
    config, mix = small(workload)
    r = readings(workload, [31, 32], [31, 32], device="cpu", config=config, mix=mix)
    # fp8 operands against bfloat16 ones: the frames' gap at least three times the program's
    assert r["control_min"]["frames_gap"] >= 3 * r["program_max"]["frames_gap"], r
    if workload == LONGFORM:   # a bfloat16 reactor against the program's float32
        assert r["control_min"]["latents_gap"] >= 3 * r["program_max"]["latents_gap"], r


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is measured at the cell's own size")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [LONGFORM, PATCH])
def test_control_fails_the_cells_limits_on_the_card(card, workload):
    limits = load_json(HERE / "limits" / f"{workload}.json")["limits"]
    r = readings(workload, [61, 62, 63], [61, 62, 63])
    for seed, numbers in r["control"].items():
        assert not judge(numbers, limits)[0], (seed, numbers)
    for seed, numbers in r["program"].items():
        assert judge(numbers, limits)[0], (seed, numbers)
