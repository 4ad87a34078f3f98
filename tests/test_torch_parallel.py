"""The port's meshes and sharded features (``ssar_tpu_torch/parallel/``) on
gloo process groups of 2 and 4 CPU ranks, against one process and against
the JAX package on the conftest's 8-device CPU mesh.  The channel-parallel
synthesis and the frame-sharded render are in
tests/test_torch_parallel_synthesis.py, the trainer in
tests/test_torch_parallel_train.py, the dry run in
tests/test_torch_parallel_dryrun.py.

The ranks are spawned by ``ssar_tpu_torch.parallel.launch.run`` (one
intra-op thread each, a ``file://`` rendezvous in a temporary directory) and
run functions of ``tests/torch_parallel_workers.py`` or of the package.
Tolerances:
- the mesh helpers and a world of one: exact;
- ``audio2features_sharded`` against JAX's within docs/PARITY.md's budgets
  (``PARITY_BUDGETS``), as the long form is held; against the port's
  ``audio2features_long`` on the same chunk plan within 1e-6 of each group's
  largest magnitude (the same ``_core`` and ``_assemble``; only the gather
  lies between them).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from ssar_tpu_torch.audio.features import PARITY_BUDGETS
from ssar_tpu_torch.parallel import features_sp as t_sp
from ssar_tpu_torch.parallel import launch, mesh as t_mesh
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

j_sp = importlib.import_module("ssar_tpu.parallel.features_sp")
j_mesh = importlib.import_module("ssar_tpu.parallel.mesh")

FPS = 24
SR = 1024 * FPS


# ---------------------------------------------------------------------- mesh --
def test_world_of_one_without_a_group():
    """No process group, no WORLD_SIZE: a local mesh, identities."""
    mesh = t_mesh.get_mesh(device="cpu")
    assert mesh.size() == 1 and mesh.mesh_dim_names == ("data",)
    grid = t_mesh.make_mesh((1, 1), ("data", "tp"), device="cpu")
    assert grid.size() == 1 and t_mesh.axis_size(grid, "tp") == 1
    x = torch.arange(6.0)
    tree = {"a": x, "b": [x]}
    assert t_mesh.shard_batch(x) is x and t_mesh.replicate(tree) is tree and tree["a"] is x
    assert [type(p).__name__ for p in t_mesh.data_sharding(grid, 3)] == ["Shard", "Replicate"]
    with pytest.raises(ValueError):
        t_mesh.get_mesh(2, device="cpu")


@pytest.mark.parametrize("world,tp", [(2, 1), (4, 2)])
def test_mesh_helpers_on_gloo_ranks(world, tp):
    out = launch.run(world, W.mesh_checks, tp)
    x = np.arange(4 * world * 3, dtype=np.float32).reshape(4 * world, 3)
    dp = world // tp
    for rank, r in enumerate(out):
        assert r["size"] == world and r["names"] == ("data",)
        assert r["grid"] == (dp, tp) and r["grid_names"] == ("data", "tp")
        assert r["placement"] == ["Shard", "Replicate"]
        np.testing.assert_array_equal(r["rows"], x[4 * rank : 4 * (rank + 1)])
        d = r["grid_data_rank"]
        assert d == rank // tp
        np.testing.assert_array_equal(r["grid_rows"], x[4 * world // dp * d : 4 * world // dp * (d + 1)])
        # an indivisible leading dim: the whole batch, and one warning in the process
        assert r["whole"] == [4 * world + 1] * 2
        assert len(r["warnings"]) == 1 and "not divisible by mesh size" in r["warnings"][0]
        # rank 0's values everywhere
        np.testing.assert_array_equal(r["tree"]["a"], np.zeros(3))
        np.testing.assert_array_equal(r["tree"]["b"][0], np.full((2, 2), 10.0))
        assert int(r["tree"]["n"]) == 0
        np.testing.assert_array_equal(r["weight"], np.zeros((2, 3)))


def test_indivisible_warning_text_matches_jax():
    """The warning the port gives is the JAX package's, word for word."""
    src = importlib.util.find_spec("ssar_tpu.parallel.mesh").origin
    text = open(src).read()
    for part in ("not divisible by mesh size", "batch REPLICATED (no data parallelism)",
                 "Pad the batch to a multiple of the mesh for full throughput."):
        assert part in text and part in open(t_mesh.__file__).read()


# ------------------------------------------------------------------ features --
def _track(frames: int) -> np.ndarray:
    t = np.arange(frames * 1024) / SR
    rng = np.random.RandomState(3)
    audio = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.randn(len(t))
    audio[:: SR // 2] += 1.0
    return audio.astype(np.float32)


def test_sharded_features_match_jax_and_the_long_form():
    """288 frames over 2 ranks: chunks of 144 + 2 x 64 frames of halo (272 <
    288, so pass 1 really is sharded), the boundary at frame 144."""
    T = 288
    audio = _track(T)
    fpc, _, cf, _, _ = t_sp._chunk_plan(T, 2)
    assert cf < T
    want = np.asarray(j_sp.audio2features_sharded(jnp.asarray(audio), SR, FPS, mesh=j_mesh.get_mesh(2), tuning=0.0))
    got = launch.run(2, t_sp.audio2features_sharded, audio, SR, FPS, tuning=0.0, device="cpu")
    np.testing.assert_array_equal(got[0], got[1])
    got = got[0]
    assert got.shape == want.shape == (T, 59)
    for group, (cols, budget) in PARITY_BUDGETS.items():
        err = np.abs(got[:, cols] - want[:, cols]).max()
        assert err <= budget, f"{group}: {err:.3g} > {budget}"
    long = t_sp.audio2features_long(audio, SR, FPS, chunk_frames=fpc, tuning=0.0, device="cpu").numpy()
    for group, (cols, _) in PARITY_BUDGETS.items():
        scale = np.abs(long[:, cols]).max() + 1e-12
        assert np.abs(got[:, cols] - long[:, cols]).max() <= 1e-6 * scale, group


def test_sharded_features_estimate_the_tuning_on_rank_0():
    """tuning=None: rank 0's host estimate from the first chunk is broadcast;
    the result equals the long form's, which estimates from the same 4 s."""
    T = 288
    audio = _track(T)
    got = launch.run(2, t_sp.audio2features_sharded, audio, SR, FPS, device="cpu")
    long = t_sp.audio2features_long(audio, SR, FPS, chunk_frames=T // 2, device="cpu").numpy()
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_allclose(got[0], long, rtol=0, atol=1e-6 * np.abs(long).max())


def test_sharded_features_hand_a_short_track_to_the_whole_track_stack():
    """One rank, or a track no longer than a chunk with its halos: the whole-track stack."""
    from ssar_tpu_torch.audio.features import audio2features

    audio = _track(96)
    want = audio2features(audio, SR, FPS, tuning=0.0, device="cpu").numpy()
    np.testing.assert_array_equal(t_sp.audio2features_sharded(audio, SR, FPS, tuning=0.0, device="cpu").numpy(), want)
