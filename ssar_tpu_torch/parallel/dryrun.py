"""The multichip dry run: the supervised train step over a (dp, tp) mesh, held
against one device, then channel-parallel synthesis on the same mesh.

Port of ``__graft_entry__.py:dryrun_multichip``.  The mesh is (n / 2, 2)
for an even n, else (n, 1).  A GRU ``LatentNoiseReactor`` at the config of
record (hidden 32, 4 layers, a random (96, 18, 512) palette, the envelope
head's bias seeded to +1 so that the fixed decoder's ``env / env.sum``
starts near convex weights) takes K = 6 Adam(1e-3) steps of the supervised
loss on a batch of B = 32 windows of T = 192 frames drawn from
``RandomState(0)``, with the noise of step k drawn from a generator seeded
100 + k.  The batch rows are split over ``dp``; the W+ feature axis of the
latent targets and predictions over ``tp``: each rank sums the squared error
of its block, and the sums and the gradients are reduced over ``tp`` and
then ``dp``.  The trajectory must equal the one-device trajectory (full
batch, ``supervised_loss``) within rtol 5e-4 and fall.  Then
``synthesize_tp`` renders B = 2 dp random W+ latents at 256 px, in float32,
on the same mesh, and the frames must be finite.

For n > 1 the ranks are gloo processes on the CPU (``launch.run``), as the
JAX function repins itself to a virtual CPU mesh; the one-device reference
runs on the CPU in a thread of the calling process meanwhile.  For n = 1 everything runs on the
card (or on `device`).
"""
from __future__ import annotations

import concurrent.futures
import time

import numpy as np
import torch
import torch.distributed as dist

from ..gan import stylegan2 as sg
from ..generate import keys
from ..models.reactor import LatentNoiseReactor
from ..train.losses import supervised_loss
from ..train.train import ClippedAdam
from ..utils.device import resolve_device
from .mesh import axis_rank, axis_size, make_mesh, replicate
from .synthesis_tp import synthesize_tp

F, N_SPLIT, NOISE_SIZES = 59, 3, (4, 8, 16, 32)


def _batch(B: int, T: int) -> list[np.ndarray]:
    rng = np.random.RandomState(0)
    return [rng.randn(B, T, F).astype(np.float32), rng.randn(B, T, 18, 512).astype(np.float32),
            *[rng.randn(B, T, s, s).astype(np.float32) for s in NOISE_SIZES]]


def _model(hidden: int, num_layers: int, device) -> LatentNoiseReactor:
    palette = torch.randn((N_SPLIT * hidden, 18, 512), generator=torch.Generator().manual_seed(0))
    torch.manual_seed(1)
    model = LatentNoiseReactor(np.zeros(F, np.float32), np.ones(F, np.float32), palette, backbone="gru",
                               hidden_size=hidden, num_layers=num_layers)
    with torch.no_grad():
        model.envelopes.out.bias += 1.0
    return model.to(device)


def _reference(B: int, T: int, hidden: int, num_layers: int, steps: int, device) -> list[float]:
    """The one-device trajectory: the whole batch, ``supervised_loss``."""
    batch = _batch(B, T)
    model = _model(hidden, num_layers, device)
    params = [p for p in model.parameters() if p.requires_grad]
    opt = ClippedAdam(params, 1e-3)
    inputs, latents, *noise = [torch.as_tensor(a, device=device) for a in batch]
    losses = []
    for k in range(steps):
        pl, pn = model(inputs, generator=torch.Generator(device).manual_seed(100 + k))
        loss = supervised_loss(pl, pn, latents, noise)
        opt.step(torch.autograd.grad(loss, params))
        losses.append(float(loss.detach()))
    return losses


def _sharded(B: int, T: int, hidden: int, num_layers: int, steps: int, resolution: int, device, mesh) -> dict:
    """One rank of the sharded trajectory and of the TP synthesis (each rank
    draws the batch itself: sending it would pickle it to every rank)."""
    device = resolve_device(device)
    dp, tp = axis_size(mesh, "dp"), axis_size(mesh, "tp")
    d, t = axis_rank(mesh, "dp"), axis_rank(mesh, "tp")
    batch = _batch(B, T)
    b, w = B // dp, 512 // tp
    rows, cols = slice(d * b, (d + 1) * b), slice(t * w, (t + 1) * w)
    inputs, latents, *noise = [torch.as_tensor(a[rows], device=device) for a in batch]
    latents = latents[..., cols]
    model = replicate(_model(hidden, num_layers, device), mesh)
    params = [p for p in model.parameters() if p.requires_grad]
    opt = ClippedAdam(params, 1e-3)
    groups = [(mesh.get_group(name), n) for name, n in (("tp", tp), ("dp", dp)) if n > 1]
    n_lat = B * T * 18 * 512
    losses = []
    t0 = time.perf_counter()
    for k in range(steps):
        with keys.batch_rows(d, dp):
            pl, pn = model(inputs, generator=torch.Generator(device).manual_seed(100 + k))
        # this rank's share of the loss: its block of the latent error, and its rows' noise error
        # once over tp (each tp rank holds the same rows)
        local = ((pl[..., cols] - latents) ** 2).sum() / n_lat
        for p, n in zip(pn, noise):
            local = local + ((p - n) ** 2).sum() / (B * n[0].numel()) / tp
        grads = torch.autograd.grad(local, params)
        flat = torch.cat([g.reshape(-1) for g in grads] + [local.detach().reshape(1)])
        for group, _ in groups:
            dist.all_reduce(flat, group=group)
        grads = [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads] + [1]), grads)]
        opt.step(grads)
        losses.append(float(flat[-1]))

    t1 = time.perf_counter()
    cfg = sg.StyleGAN2Config(resolution=resolution)
    gparams = sg.init_generator(cfg, torch.Generator().manual_seed(3), device=device)
    lat = torch.randn((2 * dp, cfg.n_latent, 512), generator=torch.Generator().manual_seed(4)).to(device)
    frames = synthesize_tp(gparams, lat, None, cfg, mesh, dtype=torch.float32, data_axis="dp")
    return {"losses": losses, "tp_synth": tuple(frames.shape), "finite": bool(torch.isfinite(frames).all()),
            "steps_s": t1 - t0, "synthesis_s": time.perf_counter() - t1}


def dryrun_multichip(n_devices: int, *, batch: int = 32, frames: int = 192, hidden: int = 32, num_layers: int = 4,
                     steps: int = 6, resolution: int = 256, device: str | torch.device | None = None) -> dict:
    """The dry run on `n_devices` ranks at the given shapes (the defaults are
    the config of record); raises unless the sharded trajectory matches the
    one-device one within rtol 5e-4, falls and the TP frames are finite.
    Prints the JAX function's summary line; returns the mesh, both
    trajectories, the frames' shape and seconds: the sharded run's (for
    n > 1 the ranks' start included) and rank 0's steps and synthesis."""
    from . import launch

    tp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    dp = n_devices // tp
    B = max(batch // dp, 1) * dp
    shapes = (B, frames, hidden, num_layers, steps)
    if n_devices == 1:
        device = resolve_device(device)
        ref = _reference(*shapes, device)
        t0 = time.perf_counter()
        out = _sharded(*shapes, resolution, device, make_mesh((1, 1), ("dp", "tp"), device=device))
        t1 = time.perf_counter()
    else:   # the one-device run in a thread of this process while the ranks start and run
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            pending = pool.submit(_reference, *shapes, "cpu")
            t0 = time.perf_counter()
            out = launch.run(n_devices, _sharded, *shapes, resolution, "cpu", mesh=((dp, tp), ("dp", "tp")))[0]
            t1 = time.perf_counter()
            ref = pending.result()
    seconds = {"sharded": t1 - t0, "rank0_steps": out["steps_s"], "rank0_synthesis": out["synthesis_s"]}
    losses = out["losses"]
    if not np.isfinite(losses).all():
        raise RuntimeError(f"multichip dry-run produced a non-finite loss: {losses}")
    # sharded == one device, step for step: the reduction order differs (block sums reduced over the
    # ranks against one mean), ~sqrt(N) eps of the ~5.7e7-element mean; a sharding fault is O(1)
    np.testing.assert_allclose(losses, ref, rtol=5e-4)
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss did not decrease over {steps} steps: {losses}")
    if not out["finite"]:
        raise RuntimeError("TP synthesis produced non-finite frames")
    traj = " ".join(f"{v:.6f}" for v in losses)
    print(f"dryrun_multichip({n_devices}): mesh=({dp}x{tp}) losses=[{traj}] "
          f"(single-device match rtol=5e-4, decreasing) tp_synth={out['tp_synth']} OK", flush=True)
    return {"mesh": (dp, tp), "losses": losses, "reference": ref, "tp_synth": out["tp_synth"], "seconds": seconds}
