"""StyleGAN2 mapper / synthesizer wrappers.

Counterpart of ``StyleGAN2Mapper``, ``StyleGAN2Synthesizer`` and
``load_params`` in ``ssar_tpu/gan/wrapper.py``.  ``model_file`` is ``None``
(random init from ``seed``) or an ``.npz`` of the JAX package's parameter
pytree (``ssar_tpu.gan.convert.save_npz`` layout: "/"-joined keys, list
indices as numbers), converted to torch layout on load.  Both run on the CUDA
device unless ``device`` says otherwise.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from . import stylegan2 as sg


def _unflatten(flat: dict) -> dict:
    """{"convs/0/weight": a, ...} -> nested dicts, with numeric keys as lists."""
    root: dict = {}
    for key, value in flat.items():
        node = root
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[k]) for k in sorted(node, key=int)]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def load_npz(path: str, device=None) -> dict:
    """A JAX-layout ``.npz`` checkpoint (f16 storage allowed) as torch params."""
    with np.load(path) as data:
        flat = {k: data[k].astype(np.float32) for k in data.files}
    return sg.params_from_jax(_unflatten(flat), device=device)


def load_params(model_file: str | None, config: sg.StyleGAN2Config, seed: int = 0, device=None) -> dict:
    if model_file is None:
        return sg.init_generator(config, torch.Generator().manual_seed(seed), device=device)
    if str(model_file).endswith(".npz"):
        return load_npz(model_file, device=device)
    raise NotImplementedError(f"checkpoint format not ported yet: {model_file} (use .npz or None)")


class StyleGAN2Mapper:
    """z (B, 512) -> W+ (B, n_latent, 512)."""

    def __init__(self, model_file: str | None = None, config: sg.StyleGAN2Config | None = None,
                 seed: int = 0, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.config = config or sg.StyleGAN2Config()
        self.params = load_params(model_file, self.config, seed, self.device)

    @torch.no_grad()
    def __call__(self, z) -> torch.Tensor:
        z = torch.as_tensor(z, dtype=torch.float32).to(self.device)
        return sg.w_to_wplus(sg.mapping(self.params, z, self.config), self.config)


class StyleGAN2Synthesizer:
    """W+ latents + noise pyramid -> frames (B, H, W, 3) in [-1, 1] (unclamped).

    ``output_size`` (W, H) is square and a power of two up to the native
    resolution; below it the network stops at that level's skip branch.
    (Resizing to other sizes is not ported yet.)
    """

    def __init__(self, model_file: str | None = None, output_size: tuple[int, int] | None = None,
                 config: sg.StyleGAN2Config | None = None, seed: int = 0, dtype=torch.bfloat16,
                 device: str | torch.device | None = None, params: dict | None = None):
        self.device = resolve_device(device)
        self.config = config or sg.StyleGAN2Config()
        self.params = params if params is not None else load_params(model_file, self.config, seed, self.device)
        self.dtype = dtype
        native = self.config.resolution
        self.synth_res = native if output_size is None else int(output_size[0])
        if output_size is not None and (output_size[0] != output_size[1] or self.synth_res > native
                                        or self.synth_res < 4 or self.synth_res & (self.synth_res - 1)):
            raise ValueError(f"output_size must be square, a power of two and at most {native}: {output_size}")
        # weight-derived constants, computed once per checkpoint
        self.prep = sg.prepare_synthesis(self.params, self.config, self.dtype)

    @property
    def n_noises_used(self) -> int:
        """Number of noise layers consumed at the synthesis resolution."""
        return (int(np.log2(self.synth_res)) - 2) * 2 + 1

    @torch.no_grad()
    def __call__(self, latents, noises: list | None = None) -> torch.Tensor:
        """latents (B, n_ws, 512); noises: list of (B, H, W, 1) (None entries
        mean no noise at that layer), or None."""
        latents = torch.as_tensor(latents, dtype=torch.float32).to(self.device)
        if noises is not None:
            n_used = self.n_noises_used
            noises = [None if n is None else torch.as_tensor(n).to(self.device, self.dtype)
                      for n in list(noises)[:n_used]]
            noises += [None] * (self.config.num_layers - len(noises))
        return sg.synthesis(self.params, latents, noises, self.config, dtype=self.dtype,
                            output_size=self.synth_res, prep=self.prep)
