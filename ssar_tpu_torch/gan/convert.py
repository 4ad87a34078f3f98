"""Checkpoint converters: rosinality ``.pt``, NVIDIA ``.pkl`` and the JAX
package's ``.npz`` -> the port's parameter dict.

Counterpart of ``ssar_tpu/gan/convert.py``.  Each loader first builds the
JAX package's layout as numpy arrays ((kh, kw, in, out) convs, (in, out)
linears, (4, 4, C) const), exactly as the reference's loaders do, and hands it
to ``stylegan2.params_from_jax``; ``save_npz`` writes the port's parameters
back in that layout, so the two packages read each other's files.

- rosinality ``.pt``: ``torch.load`` of a Generator state dict (under
  ``g_ema`` / ``g`` or bare).  Its transposed-conv layers store weights as
  its regular convs do (the transpose happens at call time).
- NVIDIA ``.pkl`` (stylegan2-ada-pytorch): a stub unpickler rebuilds
  ``torch_utils.persistence`` objects as metadata dicts without running the
  source they embed, and ada's names and layouts are mapped onto the tree.
- ``.npz``: "/"-joined keys of the JAX layout, list indices as numbers,
  float16 storage allowed.
"""
from __future__ import annotations

import io
import pickle

import numpy as np
import torch

from . import stylegan2 as sg


def _np(w) -> np.ndarray:
    """A tensor (or array) as a float32 numpy array."""
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    return np.asarray(w, dtype=np.float32)


def load_rosinality_pt(path: str, config: sg.StyleGAN2Config, device=None) -> dict:
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("g_ema", ckpt.get("g", ckpt)) if isinstance(ckpt, dict) else ckpt
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return convert_rosinality_sd(sd, config, device=device)


def rosinality_tree(sd: dict, config: sg.StyleGAN2Config) -> dict:
    """rosinality Generator state dict -> the JAX package's layout (numpy)."""

    def conv_w(key):  # (1, out, in, kh, kw) -> (kh, kw, in, out)
        w = _np(sd[key])
        if w.ndim == 5:
            w = w[0]
        return w.transpose(2, 3, 1, 0)

    def lin(prefix):
        return {"weight": _np(sd[f"{prefix}.weight"]).T, "bias": _np(sd[f"{prefix}.bias"])}

    def styled(prefix):
        return {"weight": conv_w(f"{prefix}.conv.weight"), "mod": lin(f"{prefix}.conv.modulation"),
                "noise_weight": _np(sd[f"{prefix}.noise.weight"]).reshape(()),
                "bias": _np(sd[f"{prefix}.activate.bias"])}

    def torgb(prefix):
        return {"weight": conv_w(f"{prefix}.conv.weight"), "mod": lin(f"{prefix}.conv.modulation"),
                "bias": _np(sd[f"{prefix}.bias"]).reshape(-1)}

    return {
        "mapping": [lin(f"style.{i + 1}") for i in range(config.n_mlp)],
        "const": _np(sd["input.input"])[0].transpose(1, 2, 0),
        "conv1": styled("conv1"),
        "to_rgb1": torgb("to_rgb1"),
        "convs": [styled(f"convs.{i}") for i in range((config.log_size - 2) * 2)],
        "to_rgbs": [torgb(f"to_rgbs.{i}") for i in range(config.log_size - 2)],
        "w_avg": _np(sd["latent_avg"]).reshape(-1) if "latent_avg" in sd
        else np.zeros((config.style_dim,), np.float32),
    }


def convert_rosinality_sd(sd: dict, config: sg.StyleGAN2Config, device=None) -> dict:
    """rosinality Generator state dict -> the port's parameters."""
    return sg.params_from_jax(rosinality_tree(sd, config), device=device)


# ------------------------------------------------------------------ .npz --
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


def load_npz_tree(path: str) -> dict:
    """Any JAX-layout ``.npz`` (a generator's, or a discriminator's
    ``{"params": ...}``) as its nested tree of float32 numpy arrays."""
    with np.load(path) as data:
        return _unflatten({k: data[k].astype(np.float32) for k in data.files})


def load_npz(path: str, device=None) -> dict:
    """A JAX-layout ``.npz`` checkpoint (float16 storage allowed) as the port's
    parameters."""
    return sg.params_from_jax(load_npz_tree(path), device=device)


def save_npz(path: str, params: dict, dtype=None) -> None:
    """The port's generator parameters, or any tree already in the JAX
    package's layout (a discriminator's ``{"params": discriminator_flax_tree(D)}``),
    as a JAX-layout ``.npz`` that ``load_npz`` of either package reads;
    stored as `dtype` (e.g. ``np.float16``) when given."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}/", v)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(f"{prefix}{i}/", v)
        else:
            a = node.detach().cpu().float().numpy() if torch.is_tensor(node) else np.asarray(node)
            flat[prefix[:-1]] = a if dtype is None else a.astype(dtype)

    generator = "const" in params and "mapping" in params
    walk("", sg.params_to_jax(params) if generator else params)
    np.savez(path, **flat)


# ------------------------------------------------------------ NVIDIA .pkl --
def _unpickle_nvidia(path: str):
    """Unpickle a stylegan2-ada-pytorch snapshot WITHOUT running the source
    it embeds: ``torch_utils.persistence`` objects come back as plain
    metadata dicts (class name + state)."""

    class _Stub(dict):
        pass

    def _reconstruct(meta):  # torch_utils.persistence._reconstruct_persistent_obj
        return _Stub(meta)

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module.startswith("torch_utils") or module.startswith("dnnlib"):
                if name == "_reconstruct_persistent_obj":
                    return _reconstruct
                return _Stub  # EasyDict and friends
            return super().find_class(module, name)

        def persistent_load(self, pid):  # legacy TF pickles
            raise pickle.UnpicklingError("TF-era NVIDIA pickles are not supported")

    with open(path, "rb") as f:
        data = f.read()
    # tensors inside use torch's zip or legacy storage: a zip archive goes
    # through torch.load with the stub unpickler, anything else is a plain pickle
    module = type("StubPickle", (), {"Unpickler": _Unpickler,
                                     "load": staticmethod(lambda *a, **k: _Unpickler(*a, **k).load())})
    try:
        return torch.load(io.BytesIO(data), map_location="cpu", weights_only=False, pickle_module=module)
    except (RuntimeError, pickle.UnpicklingError):
        return _Unpickler(io.BytesIO(data)).load()


def nvidia_tree(snap, config: sg.StyleGAN2Config, key: str = "G_ema") -> dict:
    """An unpickled stylegan2-ada-pytorch snapshot -> the JAX package's layout
    (numpy).  ada and rosinality share the equalized-lr convention (raw
    weights, a 1/sqrt(fan_in) gain at run time), so only layouts change."""
    obj = snap[key] if isinstance(snap, dict) and key in snap else snap

    def state_of(o):
        if isinstance(o, dict) and isinstance(o.get("state"), dict):
            return o["state"]
        return o

    flat: dict[str, np.ndarray] = {}

    def walk(prefix, node):  # persistence state: _parameters / _buffers / _modules trees
        if not isinstance(node, dict):
            return
        for k in ("_parameters", "_buffers"):
            for name, v in (node.get(k) or {}).items():
                if v is not None:
                    flat[f"{prefix}{name}"] = _np(v)
        for name, v in (node.get("_modules") or {}).items():
            walk(f"{prefix}{name}.", state_of(v))
        for name, v in node.items():
            if name.startswith("_"):
                continue
            if isinstance(v, (torch.Tensor, np.ndarray)):
                flat[f"{prefix}{name}"] = _np(v)
            elif isinstance(v, dict):
                walk(f"{prefix}{name}.", state_of(v))

    walk("", state_of(obj))

    def lin(prefix):
        return {"weight": flat[f"{prefix}.weight"].T, "bias": flat[f"{prefix}.bias"]}

    def styled(prefix):
        return {"weight": flat[f"{prefix}.weight"].transpose(2, 3, 1, 0), "mod": lin(f"{prefix}.affine"),
                "noise_weight": flat[f"{prefix}.noise_strength"].reshape(()), "bias": flat[f"{prefix}.bias"]}

    def torgb(prefix):
        return {"weight": flat[f"{prefix}.weight"].transpose(2, 3, 1, 0), "mod": lin(f"{prefix}.affine"),
                "bias": flat[f"{prefix}.bias"].reshape(-1)}

    convs, torgbs = [], []
    for i in range(3, config.log_size + 1):
        res = 2**i
        convs += [styled(f"synthesis.b{res}.conv0"), styled(f"synthesis.b{res}.conv1")]
        torgbs.append(torgb(f"synthesis.b{res}.torgb"))
    return {
        "mapping": [lin(f"mapping.fc{i}") for i in range(config.n_mlp)],
        "const": flat["synthesis.b4.const"].transpose(1, 2, 0),
        "conv1": styled("synthesis.b4.conv1"),
        "to_rgb1": torgb("synthesis.b4.torgb"),
        "convs": convs,
        "to_rgbs": torgbs,
        "w_avg": flat["mapping.w_avg"].reshape(-1) if "mapping.w_avg" in flat
        else np.zeros((config.style_dim,), np.float32),
    }


def load_nvidia_pkl(path: str, config: sg.StyleGAN2Config, key: str = "G_ema", device=None) -> dict:
    """NVIDIA stylegan2-ada-pytorch ``.pkl`` -> the port's parameters."""
    return sg.params_from_jax(nvidia_tree(_unpickle_nvidia(path), config, key), device=device)
