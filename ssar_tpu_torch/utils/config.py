"""The configuration tree and JSON config files for the entry points.

The port's copy of ``ssar_tpu/utils/config.py`` (plain Python, kept here so
that the port imports nothing of the JAX package): one dataclass tree covers
audio, GAN, model and training settings, with ``section.attr=value``
overrides, a JSON round trip and the run name the trainer stores; and
``apply_config_file`` overlays a JSON file onto an entry point's argparse
flags.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


@dataclass
class AudioConfig:
    fps: int = 24
    n_features: int = 59
    clamp: bool = True
    smooth: bool = True
    emphasis: bool = False


@dataclass
class GANConfig:
    model_file: str | None = None
    resolution: int = 1024
    channel_multiplier: int = 2
    output_size: tuple[int, int] | None = None
    strategy: str = "stretch"
    layer: int = 0


@dataclass
class ModelConfig:
    decoder: str = "learned"
    backbone: str = "gru"
    n_latent_split: int = 3
    hidden_size: int = 16
    num_layers: int = 4
    dropout: float = 0.0
    residual: bool = False
    n_noise: int = 4


@dataclass
class TrainConfig:
    loss: str = "supervised"
    n_examples: int = 128_000
    lr: float = 1e-4
    batch_size: int = 32
    eval_every: int = 10_240
    ckpt_every: int = 10_240
    duration: int = 8
    seed: int = 42
    cache_dir: str | None = None
    out_dir: str = "runs"


@dataclass
class Config:
    audio: AudioConfig = field(default_factory=AudioConfig)
    gan: GANConfig = field(default_factory=GANConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save(self, path: str) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2))

    @classmethod
    def load(cls, path: str) -> "Config":
        return cls.from_dict(json.loads(Path(path).read_text()))

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        """A sectioned dict; keys a section does not have are ignored."""
        cfg = cls()
        for section, values in d.items():
            sub = getattr(cfg, section)
            for k, v in values.items():
                if hasattr(sub, k):
                    setattr(sub, k, tuple(v) if isinstance(getattr(sub, k), tuple) and v else v)
        return cfg

    def apply_overrides(self, overrides: list[str]) -> "Config":
        """["train.lr=3e-4", "model.backbone=sashimi", ...]: each value is
        parsed as the type of the field's current value."""
        for ov in overrides:
            key, _, raw = ov.lstrip("-").partition("=")
            section, _, attr = key.partition(".")
            sub = getattr(self, section)
            current = getattr(sub, attr)
            value: Any = raw
            if isinstance(current, bool):
                value = raw.lower() in ("1", "true", "yes")
            elif isinstance(current, int):
                value = int(raw)
            elif isinstance(current, float):
                value = float(raw)
            elif current is None and raw.lower() in ("none", "null"):
                value = None
            setattr(sub, attr, value)
        return self

    def run_name(self) -> str:
        m, t = self.model, self.train
        return "_".join([m.backbone, t.loss, m.decoder, f"split{m.n_latent_split}",
                         f"hid{m.hidden_size}", f"layers{m.num_layers}", f"lr{t.lr}"])


def _flatten(d: dict) -> dict:
    """Sectioned config dicts {"train": {"lr": ...}} flatten to {dest: value};
    flat dicts pass through."""
    out: dict = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(v)
        else:
            out[k] = v
    return out


def apply_config_file(parser, args, path: str, argv=None):
    """Overlay a JSON config file onto parsed argparse args.

    Precedence: explicit CLI flag > config file > argparse default.  Accepts a
    flat {dest: value} dict or the sectioned format; unknown keys are
    reported, not fatal.
    """
    data = _flatten(json.loads(Path(path).read_text()))
    tokens = list(argv if argv is not None else sys.argv[1:])
    given = {t[2:].split("=")[0].replace("-", "_") for t in tokens if t.startswith("--")}
    for k, v in data.items():
        if k == "config":
            continue
        if not hasattr(args, k):
            print(f"config: ignoring unknown key {k!r}")
            continue
        if k in given:
            continue
        setattr(args, k, v)
    return args
