"""Channel-parallel StyleGAN2 synthesis over a (data, tp) mesh.

Counterpart of ``ssar_tpu/parallel/synthesis_tp.py``.  The JAX package
annotates the generator's tensors with their placement and lets XLA's SPMD
partitioner insert the collectives; here they are written out:

- ``shard_generator_params`` applies the JAX rule: a tensor of three or more
  axes whose output-channel axis is longer than 3 and divided by ``tp``
  keeps this tp rank's slice of it (every styled conv's kernel and the const
  input; in the port's layout the output channel is axis 0, of a conv's
  (out, in, kh, kw) weight and of the (C, 4, 4) const); everything else is
  replicated, the to_rgb convs' 3 channels included.
- ``synthesize_tp`` runs each styled conv for this rank's output channels
  only: its kernel slice (an up-conv's prepared (in, out, kh, kw) kernel
  follows from the weight), its rows of the demodulation Gram and its slice
  of the bias; the style, one scale per input channel, is computed whole.
  The const input stays whole here, as conv1 reads every channel of it.
  After each styled conv the channel slices are gathered over ``tp``
  (``all_gather``), since the next conv and the replicated to_rgb read every
  channel.  Latents and noises are split over ``data`` and the frames
  gathered back, so every rank returns the whole batch.

On a mesh whose ``data`` and ``tp`` axes are both 1 it is ``synthesis``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..gan import stylegan2 as sg
from .mesh import axis_rank, axis_size


def _slice(x: torch.Tensor, n: int, rank: int) -> torch.Tensor:
    c = x.shape[0] // n
    return x.narrow(0, rank * c, c)


def shard_generator_params(params: dict, mesh, tp_axis: str = "tp") -> dict:
    """This tp rank's generator parameters: conv kernels and the const input
    cut to its slice of their output channels, everything else whole (a new
    dict; `params` is left as it is)."""
    tp, rank = axis_size(mesh, tp_axis), axis_rank(mesh, tp_axis)

    def place(x):
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        if isinstance(x, list):
            return [place(v) for v in x]
        if isinstance(x, torch.Tensor) and x.ndim >= 3 and x.shape[0] > 3 and x.shape[0] % tp == 0:
            return _slice(x, tp, rank)
        return x

    return place(params)


def _gather(x: torch.Tensor, n: int, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


@torch.no_grad()
def synthesize_tp(params: dict, latents: torch.Tensor, noises, config: sg.StyleGAN2Config, mesh, *,
                  dtype=torch.bfloat16, data_axis: str = "data", tp_axis: str = "tp",
                  output_size: int | None = None) -> torch.Tensor:
    """TP + DP synthesis: latents (B, n_latent, 512), B divided by the
    ``data`` axis, noises a list of (B, H, W, 1) or None -> images
    (B, R, R, 3) float32, the whole batch on every rank (as ``synthesis``)."""
    dp, tp = axis_size(mesh, data_axis), axis_size(mesh, tp_axis)
    if dp == 1 and tp == 1:
        return sg.synthesis(params, latents, noises, config, dtype=dtype, output_size=output_size)
    B = latents.shape[0]
    if B % dp:
        raise ValueError(f"batch {B} is not divided by the data axis ({dp})")
    d = axis_rank(mesh, data_axis)
    latents = _slice(latents, dp, d)
    if noises is not None:
        noises = [None if n is None else _slice(n, dp, d) for n in noises]

    local = shard_generator_params(params, mesh, tp_axis)
    conv_out = None
    if tp > 1:
        t, group = axis_rank(mesh, tp_axis), mesh.get_group(tp_axis)
        local["const"] = params["const"]   # conv1 reads every channel: kept whole, no gather
        for p in [local["conv1"], *local["convs"]]:
            p["bias"] = _slice(p["bias"], tp, t)

        def conv_out(y):
            return _gather(y, tp, group, 1)

    img = sg.synthesis(local, latents, noises, config, dtype=dtype, output_size=output_size, conv_out=conv_out)
    if dp > 1:
        img = _gather(img, dp, mesh.get_group(data_axis), 0)
    return img
