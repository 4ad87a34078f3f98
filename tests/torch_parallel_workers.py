"""What the gloo ranks of tests/test_torch_parallel*.py run.

``ssar_tpu_torch.parallel.launch.run`` spawns the ranks, which import their
target by name: these functions live here, in a module that imports neither
JAX nor pytest, and reach the ranks through the test process's ``sys.path``.
"""
import warnings

import numpy as np
import torch
import torch.distributed as dist

from ssar_tpu_torch.gan import stylegan2 as sg
from ssar_tpu_torch.gan.render import render_latents_to_video
from ssar_tpu_torch.gan.wrapper import StyleGAN2Synthesizer
from ssar_tpu_torch.parallel import mesh as M


def mesh_checks(tp: int) -> dict:
    """The mesh helpers on this rank: shapes, its rows, the indivisible case's
    one warning, and tensors that start different on every rank replicated."""
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = M.get_mesh(device="cpu")
    grid = M.make_mesh((world // tp, tp), ("data", "tp"), device="cpu")
    x = torch.arange(4 * world * 3, dtype=torch.float32).reshape(4 * world, 3)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        whole = [M.shard_batch(torch.arange(4 * world + 1), mesh) for _ in range(2)]
    tree = {"a": torch.full((3,), float(rank)), "b": [torch.full((2, 2), 10.0 + rank)],
            "n": torch.tensor(rank, dtype=torch.int64)}
    M.replicate(tree, mesh)
    module = torch.nn.Linear(3, 2)
    with torch.no_grad():
        module.weight.fill_(float(rank))
    M.replicate(module)
    return {"size": mesh.size(), "names": mesh.mesh_dim_names, "grid": (grid.size(0), grid.size(1)),
            "grid_names": grid.mesh_dim_names, "grid_data_rank": M.axis_rank(grid, "data"),
            "placement": [type(p).__name__ for p in M.data_sharding(grid, 2)],
            "rows": M.shard_batch(x, mesh), "grid_rows": M.shard_batch(x, grid),
            "whole": [len(w) for w in whole], "warnings": [str(w.message) for w in caught],
            "tree": tree, "weight": module.weight}


def scale_bend(x, mod):
    """An animated bend: each frame's activations scaled by 1 + its modulation."""
    return x * (1.0 + mod[:, None, None, None])


class LazyNoise:
    """A lazy noise ``n(i, b)``: frames [i, i + b) of a per-frame noise."""

    def __init__(self, size: int, frames: int):
        self.bank = np.random.RandomState(7).randn(frames, size, size).astype(np.float32)

    def __call__(self, i: int, b: int):
        assert 0 <= i and i + b <= len(self.bank), (i, b)
        return torch.as_tensor(self.bank[i : i + b])


class FrameSink:
    def __init__(self):
        self.frames = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def write_i420(self, frame):
        self.frames.append(np.array(frame))

    def write(self, frame):
        self.frames.append(np.array(frame))


def render(params: dict, resolution: int, latents: np.ndarray, noise_bank: np.ndarray, modulation: np.ndarray,
           batch_size: int):
    """``render_latents_to_video`` of `latents` with a tensor noise, a lazy
    noise, a None slot and an animated bend, into a ``FrameSink``; the frames
    it was given (none on ranks other than 0)."""
    config = sg.StyleGAN2Config(resolution=resolution, max_channels=32)
    syn = StyleGAN2Synthesizer(config=config, dtype=torch.float32, device="cpu",
                               params={k: v for k, v in params.items()})
    syn.set_bends([{"layer": 1, "transform": scale_bend, "modulation": modulation}])
    T = latents.shape[0]
    noises = [torch.as_tensor(noise_bank), LazyNoise(8, T), None]
    return render_latents_to_video(syn, latents, noises, batch_size=batch_size, progress=False,
                                   writer=FrameSink()).frames


def step_with_base(variables, batch, base: dict, loss: str = "supervised") -> float:
    """One data-parallel step of the tests/test_parallel.py reactor with the
    base noise `base` (size -> the global batch's (B, T, s, s)) injected:
    each rank's model is handed its rows.  Returns the all-reduced loss."""
    from ssar_tpu_torch.models import reactor
    from ssar_tpu_torch.train import train

    rank = dist.get_rank()

    def injected(shape_bt, size, sigma=5.0, *, generator=None, device=None):
        b = shape_bt[0]
        return torch.as_tensor(base[size][rank * b : (rank + 1) * b])

    reactor.smoothed_noise = injected
    model = reactor.LatentNoiseReactor(np.zeros(59, np.float32), np.ones(59, np.float32), None, decoder="learned",
                                       backbone="mlp", hidden_size=8, num_layers=1, residual=False)
    model.load_flax(variables)
    opt = train.ClippedAdam([p for p in model.parameters() if p.requires_grad], 1e-3)
    step = train.make_train_step(model, opt, loss, device="cpu")[0]
    return float(step(tuple(torch.as_tensor(a) for a in batch), (None, None)))


def train_recording_grads(argv: list, n_steps: int) -> tuple:
    """``train.main(argv)``, recording the gradient that reaches the optimizer
    (on more than one rank: the mean over the ranks) at each of its first
    `n_steps` steps.  Returns (log_dir, [[tensor, ...], ...])."""
    from ssar_tpu_torch.train import train

    grads_seen = []
    step = train.ClippedAdam.step

    def recording(self, grads):
        if len(grads_seen) < n_steps:
            grads_seen.append([g.detach().clone() for g in grads])
        return step(self, grads)

    train.ClippedAdam.step = recording
    try:
        log_dir, _ = train.main(argv)
    finally:
        train.ClippedAdam.step = step
    return log_dir, grads_seen
