"""Weights for the extractors and pSp: upstream checkpoints, and the JAX
package's converted trees.

Counterpart of ``ssar_tpu/models/convert_extractors.py``.  The port's
modules keep the upstream torch layouts, so an upstream ``state_dict``
loads as it is; ``load_*`` only strip the wrappers' prefixes and drop the
classification heads:

- ``load_vggish``: torchvggish (``features.*``, ``embeddings.*``) -> ``VGGish``;
- ``load_slowfast``: a state dict of ``SlowFastVideo``'s names;
- ``load_slowfast_r50``: facebook-slowfast SLOWFAST_8x8_R50 (its config
  read from the shapes, ``slowfast_r50_config``) -> ``SlowFastR50``;
- ``load_resnet50``: torchvision / SwAV (``module.`` / ``backbone.``
  prefixes) -> ``ResNet50``.

``from_flax_*`` carry the JAX package's trees (numpy arrays, as
``load_converted`` reads its ``.npz``) across to the port's ``state_dict``,
inverting that package's layout maps: HWIO -> OIHW, DHWIO -> OIDHW, (in,
out) -> (out, in), and the (H, W, C) flatten order of the first linear after
a flatten back to torch's (C, H, W).

    python -m ssar_tpu_torch.models.convert_extractors in.npz out.pt --arch vggish

writes the port's ``state_dict`` of a JAX ``.npz`` (or, given an upstream
torch checkpoint, of that checkpoint, prefixes stripped and checked by
loading it).
"""
from __future__ import annotations

import sys

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _conv2d(w) -> torch.Tensor:  # HWIO -> OIHW
    return _t(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def _conv3d(w) -> torch.Tensor:  # DHWIO -> OIDHW
    return _t(np.transpose(np.asarray(w), (4, 3, 0, 1, 2)))


def _linear(w) -> torch.Tensor:  # (in, out) -> (out, in)
    return _t(np.transpose(np.asarray(w), (1, 0)))


def _linear_before_flatten(w, chw) -> torch.Tensor:
    """The first linear after a flatten, (H*W*C, out) in flax's (H, W, C)
    order -> torch's (out, C*H*W)."""
    C, H, W = chw
    w = np.transpose(np.asarray(w), (1, 0)).reshape(-1, H, W, C)
    return _t(np.transpose(w, (0, 3, 1, 2)).reshape(w.shape[0], C * H * W))


def _bn(sd: dict, prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(p["mean"])
    sd[f"{prefix}.running_var"] = _t(p["var"])


def _items(node) -> list:
    """A list, or a dict with keys "0", "1", ... (a list after an .npz round
    trip), in order."""
    return list(node) if isinstance(node, (list, tuple)) else [node[k] for k in sorted(node, key=int)]


# ------------------------------------------------------- JAX trees -> port --
def from_flax_vggish(tree: dict) -> dict:
    """The JAX package's VGGish tree ({"params": {Conv_i, Dense_j}}) -> ``VGGish``'s state_dict."""
    p = tree.get("params", tree)
    sd = {}
    for i, ci in enumerate([0, 3, 6, 8, 11, 13]):
        sd[f"features.{ci}.weight"] = _conv2d(p[f"Conv_{i}"]["kernel"])
        sd[f"features.{ci}.bias"] = _t(p[f"Conv_{i}"]["bias"])
    sd["embeddings.0.weight"] = _linear_before_flatten(p["Dense_0"]["kernel"], (512, 6, 4))
    sd["embeddings.0.bias"] = _t(p["Dense_0"]["bias"])
    for j, ei in enumerate([2, 4], start=1):
        sd[f"embeddings.{ei}.weight"] = _linear(p[f"Dense_{j}"]["kernel"])
        sd[f"embeddings.{ei}.bias"] = _t(p[f"Dense_{j}"]["bias"])
    return sd


def from_flax_slowfast(tree: dict) -> dict:
    """The JAX package's SlowFastVideo tree -> ``SlowFastVideo``'s state_dict."""
    p = tree.get("params", tree)
    sd = {}
    for name in ["slow_stem", "fast_stem"] + [f"{q}_b{i}" for q in ("slow", "fast") for i in range(3)]:
        sd[f"{name}.weight"] = _conv3d(p[name]["kernel"])
        sd[f"{name}.bias"] = _t(p[name]["bias"])
    sd["head.weight"] = _linear(p["Dense_0"]["kernel"])
    sd["head.bias"] = _t(p["Dense_0"]["bias"])
    return sd


def from_flax_resnet50(tree: dict) -> dict:
    """The JAX package's ResNet-50 tree -> ``ResNet50``'s (torchvision) state_dict."""
    from .resnet import BLOCKS

    sd = {"conv1.weight": _conv2d(tree["stem"]["kernel"])}
    _bn(sd, "bn1", tree["bn1"])
    for li in range(4):
        blocks = tree[f"layer{li + 1}"]
        for bi in range(BLOCKS[li]):
            bp, pre = blocks[str(bi)], f"layer{li + 1}.{bi}"
            for ci in (1, 2, 3):
                sd[f"{pre}.conv{ci}.weight"] = _conv2d(bp[f"conv{ci}"]["kernel"])
                _bn(sd, f"{pre}.bn{ci}", bp[f"bn{ci}"])
            if "downsample" in bp:
                sd[f"{pre}.downsample.0.weight"] = _conv2d(bp["downsample"]["kernel"])
                _bn(sd, f"{pre}.downsample.1", bp["downsample_bn"])
    return sd


def from_flax_slowfast_r50(tree: dict) -> dict:
    """The JAX package's SlowFast R50 tree -> ``SlowFastR50``'s
    (facebook-slowfast) state_dict."""
    sd = {}
    for p in range(2):
        sd[f"s1.pathway{p}_stem.conv.weight"] = _conv3d(tree["stem"][str(p)]["conv"])
        _bn(sd, f"s1.pathway{p}_stem.bn", tree["stem"][str(p)]["bn"])
    for k in range(len(tree["fuse"])):
        name = "s1_fuse" if k == 0 else f"s{k + 1}_fuse"
        sd[f"{name}.conv_f2s.weight"] = _conv3d(tree["fuse"][str(k)]["conv"])
        _bn(sd, f"{name}.bn", tree["fuse"][str(k)]["bn"])
    for stage in range(len(tree["stages"])):
        for p in range(2):
            blocks = tree["stages"][str(stage)][str(p)]
            for j in range(len(blocks)):
                b, pre = blocks[str(j)], f"s{stage + 2}.pathway{p}_res{j}"
                for part in ("a", "b", "c"):
                    sd[f"{pre}.branch2.{part}.weight"] = _conv3d(b[part]["conv"])
                    _bn(sd, f"{pre}.branch2.{part}_bn", b[part]["bn"])
                if "branch1" in b:
                    sd[f"{pre}.branch1.weight"] = _conv3d(b["branch1"]["conv"])
                    _bn(sd, f"{pre}.branch1_bn", b["branch1"]["bn"])
    return sd


def from_flax_psp(tree: dict) -> dict:
    """The JAX package's pSp encoder tree (``gan.psp``'s layout: "input",
    "body", and "styles" / "lat1" / "lat2", or "linear", or "out_bn" /
    "out_linear" / "linear") -> the port's encoder state_dict, which has the
    upstream pSp encoder's names (a checkpoint's ``encoder.*`` keys without
    the prefix)."""
    sd = {"input_layer.0.weight": _conv2d(tree["input"]["conv"]),
          "input_layer.2.weight": _t(tree["input"]["prelu"])}
    _bn(sd, "input_layer.1", tree["input"]["bn"])
    for i, u in enumerate(_items(tree["body"])):
        pre = f"body.{i}"
        _bn(sd, f"{pre}.res_layer.0", u["bn_in"])
        sd[f"{pre}.res_layer.1.weight"] = _conv2d(u["conv1"])
        sd[f"{pre}.res_layer.2.weight"] = _t(u["prelu"])
        sd[f"{pre}.res_layer.3.weight"] = _conv2d(u["conv2"])
        _bn(sd, f"{pre}.res_layer.4", u["bn_out"])
        if "se" in u:
            sd[f"{pre}.res_layer.5.fc1.weight"] = _conv2d(u["se"]["fc1"])
            sd[f"{pre}.res_layer.5.fc2.weight"] = _conv2d(u["se"]["fc2"])
        if "shortcut" in u:
            sd[f"{pre}.shortcut_layer.0.weight"] = _conv2d(u["shortcut"]["conv"])
            _bn(sd, f"{pre}.shortcut_layer.1", u["shortcut"]["bn"])
    if "styles" in tree:
        for j, st in enumerate(_items(tree["styles"])):
            for k, c in enumerate(_items(st["convs"])):
                sd[f"styles.{j}.convs.{2 * k}.weight"] = _conv2d(c["kernel"])
                sd[f"styles.{j}.convs.{2 * k}.bias"] = _t(c["bias"])
            sd[f"styles.{j}.linear.weight"] = _linear(st["linear"]["weight"])
            sd[f"styles.{j}.linear.bias"] = _t(st["linear"]["bias"])
        for name in ("lat1", "lat2"):
            sd[f"latlayer{name[-1]}.weight"] = _conv2d(tree[name]["kernel"])
            sd[f"latlayer{name[-1]}.bias"] = _t(tree[name]["bias"])
    if "out_bn" in tree:
        _bn(sd, "output_layer_2.0", tree["out_bn"])
        c3d = np.shape(tree["out_bn"]["scale"])[0]
        sd["output_layer_2.3.weight"] = _linear_before_flatten(tree["out_linear"]["weight"], (c3d, 7, 7))
        sd["output_layer_2.3.bias"] = _t(tree["out_linear"]["bias"])
    if "linear" in tree:
        sd["linear.weight"] = _linear(tree["linear"]["weight"])
        sd["linear.bias"] = _t(tree["linear"]["bias"])
    return sd


# -------------------------------------------------- upstream checkpoints --
def _strip(state_dict: dict, prefixes, drop=()) -> dict:
    """Keys without the wrappers' `prefixes` (repeatedly), without the keys
    that start with one of `drop`; values as float32 tensors."""
    out = {}
    for k, v in state_dict.items():
        changed = True
        while changed:
            changed = False
            for pre in prefixes:
                if k.startswith(pre):
                    k, changed = k[len(pre):], True
        if k.startswith(tuple(drop)):
            continue
        out[k] = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
    return out


def load_vggish(state_dict: dict):
    """A torchvggish state_dict -> ``VGGish`` (strict: every key used)."""
    from .extractors import VGGish

    model = VGGish()
    model.load_state_dict(_strip(state_dict, ("module.",), drop=("pproc.",)))
    return model.eval()


def load_slowfast(state_dict: dict):
    """A state dict of ``SlowFastVideo``'s names -> ``SlowFastVideo``."""
    from .extractors import SlowFastVideo

    model = SlowFastVideo()
    model.load_state_dict(_strip(state_dict, ("module.",)))
    return model.eval()


def slowfast_r50_config(state_dict: dict, alpha: int = 4):
    """``SlowFastConfig`` of a facebook-slowfast state dict (prefixes
    stripped), read from its keys and shapes; `alpha` (a stride) is not in
    the weights."""
    from .slowfast_r50 import SlowFastConfig

    sd = state_dict
    width = sd["s1.pathway0_stem.conv.weight"].shape[0]
    fast = sd["s1.pathway1_stem.conv.weight"].shape[0]
    fuse = sd["s1_fuse.conv_f2s.weight"]
    depths, tk_slow, tk_fast = [], [], []
    for stage in range(4):
        j = 0
        while f"s{stage + 2}.pathway0_res{j}.branch2.a.weight" in sd:
            j += 1
        depths.append(j)
        tk_slow.append(sd[f"s{stage + 2}.pathway0_res0.branch2.a.weight"].shape[2])
        tk_fast.append(sd[f"s{stage + 2}.pathway1_res0.branch2.a.weight"].shape[2])
    return SlowFastConfig(alpha=alpha, beta_inv=width // fast, width=width, depths=tuple(depths),
                          fusion_kernel=fuse.shape[2], fusion_ratio=fuse.shape[0] // fast,
                          temp_kernels_slow=tuple(tk_slow), temp_kernels_fast=tuple(tk_fast))


def load_slowfast_r50(state_dict: dict, alpha: int = 4):
    """A facebook-slowfast SLOWFAST_8x8_R50 state_dict (a ``.pyth``'s
    ``model_state``) -> ``SlowFastR50``; the classification head is dropped."""
    from .slowfast_r50 import SlowFastR50

    sd = _strip(state_dict.get("model_state", state_dict), ("module.", "model."), drop=("head.",))
    model = SlowFastR50(slowfast_r50_config(sd, alpha))
    model.load_state_dict(sd)
    return model.eval()


def load_resnet50(state_dict: dict):
    """A torchvision or SwAV ResNet-50 state_dict -> ``ResNet50`` (the ``fc``
    and SwAV's projection head and prototypes dropped; the stage widths read
    from the weights)."""
    from .resnet import ResNet50

    sd = _strip(state_dict, ("module.", "backbone.", "encoder."), drop=("fc.", "projection_head.", "prototypes."))
    model = ResNet50(tuple(sd[f"layer{i}.0.conv1.weight"].shape[0] for i in range(1, 5)))
    model.load_state_dict(sd)
    return model.eval()


# --------------------------------------------------------------- .npz --
def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """{"a": {"b": x}} -> {"a/b": x}; list items keyed by their index."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list, tuple)):
            out.update(flatten_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten_tree(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_converted(tree: dict, out_path: str) -> None:
    np.savez(out_path, **flatten_tree(tree))


def load_converted(path: str) -> dict:
    with np.load(path) as z:
        return unflatten_tree({k: z[k] for k in z.files})


FROM_FLAX = {"vggish": from_flax_vggish, "slowfast": from_flax_slowfast, "slowfast_r50": from_flax_slowfast_r50,
             "resnet50": from_flax_resnet50, "psp": from_flax_psp}


def _upstream_state_dict(path: str, arch: str) -> dict:
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.state_dict() if hasattr(ckpt, "state_dict") else ckpt
    if isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    loader = {"vggish": load_vggish, "slowfast": load_slowfast, "slowfast_r50": load_slowfast_r50,
              "resnet50": load_resnet50}[arch]
    return loader(sd).state_dict()


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("src", help="the JAX package's converted .npz, or an upstream torch checkpoint")
    p.add_argument("out", help="output .pt (the port's state_dict)")
    p.add_argument("--arch", choices=list(FROM_FLAX), default="vggish")
    args = p.parse_args(argv)
    if args.src.endswith(".npz"):
        tree = load_converted(args.src)
        sd = FROM_FLAX[args.arch](tree["encoder"] if args.arch == "psp" and "encoder" in tree else tree)
    elif args.arch == "psp":
        raise SystemExit("an upstream pSp checkpoint loads as it is: gan.psp.convert_psp")
    else:
        sd = _upstream_state_dict(args.src, args.arch)
    torch.save(sd, args.out)
    n = sum(v.numel() for k, v in sd.items() if not k.endswith("num_batches_tracked"))
    print(f"wrote {args.out}: {n:,} parameters ({args.arch})")


if __name__ == "__main__":
    main(sys.argv[1:])
