"""The port's data-parallel trainer on a gloo process group of 2 CPU ranks,
against one process and against the JAX package's train step.

Tolerances:
- ``train.main`` at world size 2 against one process: the 3-step loss
  trajectory at rtol 1e-5 (the mean of two half-batch means and of their
  gradients against one mean: float32 round-off), the validation loss at
  rtol 1e-6 (it runs whole on every rank), the final parameters at rtol
  1e-4 of each tensor's largest magnitude.  The noise and dropout draws are
  made at the global batch's shape on every rank (``keys.batch_rows``); a
  rank that drew at its own shape would drift at O(1e-2).  One case clips
  the gradient (a clip below the gradient's norm), which must act on the
  mean over the ranks;
- the mode that ``chip_smoke.py`` trains (Sashimi backbone, fixed decoder,
  ``ssabsdiff`` loss) at world size 2 against one process: the first step's
  gradient, the mean over the ranks of their half-batch gradients, within
  1e-5 of each tensor's largest magnitude (float32 round-off), and the
  first two losses at rtol 1e-5.  Its later losses are not held at 1e-5:
  this model's trajectory amplifies round-off by itself, and a single
  process whose first gradient is perturbed at float32 round-off's level
  drifts from an unperturbed one as far as two ranks drift from one;
- one data-parallel step against JAX's ``make_train_step`` on the shapes of
  tests/test_parallel.py, JAX's base noise injected: the loss at rtol 1e-4.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_workers as W
from ssar_tpu_torch.parallel import launch
from ssar_tpu_torch.train import train as t_train
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

j_reactor = importlib.import_module("ssar_tpu.models.reactor")
j_train = importlib.import_module("ssar_tpu.train.train")

ARGV = ["--device", "cpu", "--backbone", "gru", "--decoder", "learned", "--hidden_size", "8", "--num_layers", "2",
        "--batch_size", "4", "--duration", "1", "--lr", "1e-3", "--n_examples", "12", "--eval_every", "1000000",
        "--ckpt_every", "1000000", "--no-render_at_ckpt", "--no-fcd"]


def _rows(log_dir, tag: str) -> list[float]:
    out = []
    for line in (log_dir / "metrics.csv").read_text().splitlines():
        _, name, value = line.split(",")
        if name == tag:
            out.append(float(value))
    return out


@pytest.mark.parametrize("flags", [["--grad_clip", "0"], ["--grad_clip", "0.01", "--dropout", "0.1"]],
                         ids=["adam", "clip-dropout"])
def test_data_parallel_training_matches_one_process(tmp_path, flags):
    argv = ARGV + flags
    one_dir, one_val = t_train.main(argv + ["--out_dir", str(tmp_path / "one")])
    out = launch.run(2, t_train.main, argv + ["--out_dir", str(tmp_path / "two")])
    (two_dir, two_val), (dir1, val1) = out
    assert two_dir == dir1 and two_val == val1       # one run directory; the evaluation whole on each rank
    assert sorted(p.name for p in (tmp_path / "two").iterdir()) == [two_dir.name]
    one, two = _rows(one_dir, "Loss/supervised"), _rows(two_dir, "Loss/supervised")
    assert len(one) == len(two) == 3
    np.testing.assert_allclose(two, one, rtol=1e-5)
    np.testing.assert_allclose(two_val, one_val, rtol=1e-6)
    final_one = torch.load(t_train._latest_checkpoint(one_dir), weights_only=True)["params"]
    final_two = torch.load(t_train._latest_checkpoint(two_dir), weights_only=True)["params"]
    init = t_train.make_model(t_train.build_parser().parse_args(argv), np.zeros(59), np.ones(59), None)
    for name, p in init.state_dict().items():
        want = final_one[name]
        np.testing.assert_allclose(final_two[name], want, rtol=0, atol=1e-4 * float(want.abs().max()) + 1e-12,
                                   err_msg=name)
        if p.dtype.is_floating_point and name.endswith("weight"):
            assert not torch.equal(want, p), f"{name} did not move"


def test_data_parallel_sashimi_ssabsdiff_step_matches_one_process(tmp_path):
    argv = ARGV + ["--grad_clip", "0", "--backbone", "sashimi", "--decoder", "fixed", "--loss", "ssabsdiff"]
    one_dir, one_grads = W.train_recording_grads(argv + ["--out_dir", str(tmp_path / "one")], 1)
    (two_dir, two_grads), _ = launch.run(2, W.train_recording_grads, argv + ["--out_dir", str(tmp_path / "two")], 1)
    one, two = _rows(one_dir, "Loss/ssabsdiff"), _rows(two_dir, "Loss/ssabsdiff")
    assert len(one) == len(two) == 3
    np.testing.assert_allclose(two[:2], one[:2], rtol=1e-5)
    assert len(one_grads) == len(two_grads) == 1 and len(one_grads[0]) == len(two_grads[0])
    for want, got in zip(one_grads[0], two_grads[0]):
        want = want.numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()) + 1e-12)


def test_data_parallel_step_matches_jax():
    F, T, B = 59, 16, 8
    rng = np.random.RandomState(42)
    model = j_reactor.LatentNoiseReactor(jnp.zeros(F), jnp.ones(F), None, decoder="learned", backbone="mlp",
                                         hidden_size=8, num_layers=1, residual=False)
    x = rng.randn(B, T, F).astype(np.float32)
    variables = jax.tree_util.tree_map(np.asarray, model.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, jnp.asarray(x)))
    batch = (x, rng.randn(B, T, 18, 512).astype(np.float32),
             *[rng.randn(B, T, s, s).astype(np.float32) for s in (4, 8, 16, 32)])
    base = {s: rng.randn(B, T, s, s).astype(np.float32) for s in (4, 8, 16, 32)}
    saved = j_reactor._smoothed_noise
    j_reactor._smoothed_noise = lambda key, bt, size, sigma=5.0: jnp.asarray(base[size])
    try:
        opt = optax.adam(1e-3)
        step = j_train.make_train_step(model, opt, "supervised")[0]
        jv = jax.tree_util.tree_map(jnp.asarray, variables)
        _, _, j_loss, _ = step(jv, opt.init(jv), tuple(map(jnp.asarray, batch)), jax.random.PRNGKey(0))
    finally:
        j_reactor._smoothed_noise = saved
    got = launch.run(2, W.step_with_base, variables, batch, base)
    assert got[0] == got[1]
    np.testing.assert_allclose(got[0], float(j_loss), rtol=1e-4)
