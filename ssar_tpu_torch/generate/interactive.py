"""Interactive patch-editing loop.

Counterpart of ``ssar_tpu/generate/interactive.py``: after the music
information is retrieved, a command loop lets the user audition seeds, tweak
the intensity, set section boundaries by hand, re-roll single subpatches and
render previews.  Draws go through ``keys``.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from . import keys
from .mir import retrieve_music_information
from .patch import KeyGen, Patch

HELP = """commands:
  seed <n>        re-seed the whole patch
  intensity <x>   re-draw reactivity weights around x (e.g. 0.666)
  reroll <i>      re-draw latent subpatch i
  rerollnoise <i> re-draw noise subpatch i
  segments <a,b,c> manual section boundaries (frames) for all features
  permute          shuffle latent subpatch order
  permutenoise     shuffle noise subpatch order
  palette          draw a fresh latent palette (random_latent_vectors)
  permutepalette   shuffle the current palette rows
  revert           undo the last patch edit
  show            print the current patch
  render [secs]   render a preview clip
  save <path> / load <path>
  quit
"""


def manual_segmentation(boundaries: list[int], n_frames: int, k: int, device=None) -> torch.Tensor:
    """Frame boundaries -> hard segment labels (int64, on `device`)."""
    labels = np.zeros(n_frames, np.int64)
    for i, b in enumerate(sorted(boundaries)):
        labels[b:] = min(i + 1, k - 1)
    return torch.as_tensor(labels, device=device)


class InteractiveSession:
    def __init__(self, audio, sr: int, fps: float = 24, seed: int = 42, G=None,
                 out_dir: str = "output/interactive", device=None):
        self.audio, self.sr, self.fps = audio, sr, fps
        self.G, self.out_dir = G, out_dir
        if device is None and G is not None:
            device = G.mapper.device
        print("analyzing audio...")
        self.features, self.segmentations, self.tempo = retrieve_music_information(audio, sr, device=device)
        self.device = next(iter(self.features.values())).device
        self.seed = seed
        self.palette = None
        self._history: list = []
        self._make_patch()

    def _make_patch(self):
        self.patch = Patch(self.features, self.segmentations, self.tempo, seed=self.seed, fps=self.fps)

    def _checkpoint(self):
        self._history.append((copy.deepcopy(self.patch.latent_patches),
                              copy.deepcopy(self.patch.noise_patches), self.palette))

    # ------------------------------------------------------- commands ----
    def cmd_revert(self):
        """Undo the last edit."""
        if not self._history:
            print("nothing to revert")
            return
        lat, noi, pal = self._history.pop()
        self.patch.latent_patches, self.patch.noise_patches, self.palette = lat, noi, pal

    def cmd_permute(self, noise: bool = False):
        """Shuffle the order of the latent (or noise) subpatches."""
        self._checkpoint()
        rng = np.random.RandomState(self.seed)
        if noise:
            order = rng.permutation(len(self.patch.noise_patches))
            self.patch.noise_patches = [self.patch.noise_patches[j] for j in order]
        else:
            order = rng.permutation(len(self.patch.latent_patches))
            self.patch.latent_patches = [self.patch.latent_patches[j] for j in order]

    def cmd_palette(self, permute: bool = False, n: int = 180):
        """A fresh random W+ palette, or the current one's rows shuffled."""
        if self.G is None:
            print("no generator attached — pass G= to InteractiveSession")
            return
        self._checkpoint()
        if permute and self.palette is not None:
            order = np.random.RandomState(self.seed).permutation(self.palette.shape[0])
            self.palette = self.palette[torch.as_tensor(order, device=self.palette.device)]
        else:
            self.seed += 1
            self.palette = self.G.mapper(keys.normal(keys.PRNGKey(self.seed), (n, 512), device=self.G.mapper.device))

    def cmd_seed(self, n: int):
        self.seed = int(n)
        self._make_patch()

    def cmd_intensity(self, val: float):
        self.patch.update_intensity(float(val))

    def cmd_reroll(self, i: int, noise: bool = False):
        self._checkpoint()
        kg = KeyGen(self.seed + 1000 + i)
        if noise:
            self.patch.noise_patches[i] = self.patch._random_noise_patch(kg)
        else:
            self.patch.latent_patches[i] = self.patch._random_latent_patch(kg)

    def cmd_segments(self, boundaries: list[int]):
        n_frames = self.patch.length
        for (name, k) in list(self.segmentations.keys()):
            self.segmentations[(name, k)] = manual_segmentation(boundaries, n_frames, k, self.device)
        self.patch.segmentations = self.segmentations

    def cmd_render(self, seconds: float | None = None, batch_size: int = 16):
        if self.G is None:
            print("no generator attached — pass G= to InteractiveSession")
            return None
        from .sample import generate

        dur = seconds if seconds else None
        return generate(seed=self.seed, fps=self.fps, audio=self.audio[: int((dur or 8) * self.sr)],
                        sr=self.sr, out_dir=self.out_dir, batch_size=batch_size, config=self.G.config,
                        device=self.device)

    # ----------------------------------------------------------- loop ----
    def run(self):  # pragma: no cover - interactive
        print(HELP)
        while True:
            try:
                line = input("patch> ").strip()
            except (EOFError, KeyboardInterrupt):
                break
            if not line:
                continue
            cmd, *args = line.split()
            try:
                if cmd == "quit":
                    break
                elif cmd == "help":
                    print(HELP)
                elif cmd == "seed":
                    self.cmd_seed(int(args[0]))
                elif cmd == "intensity":
                    self.cmd_intensity(float(args[0]))
                elif cmd == "reroll":
                    self.cmd_reroll(int(args[0]))
                elif cmd == "rerollnoise":
                    self.cmd_reroll(int(args[0]), noise=True)
                elif cmd == "segments":
                    self.cmd_segments([int(x) for x in args[0].split(",")])
                elif cmd == "permute":
                    self.cmd_permute()
                elif cmd == "permutenoise":
                    self.cmd_permute(noise=True)
                elif cmd == "palette":
                    self.cmd_palette()
                elif cmd == "permutepalette":
                    self.cmd_palette(permute=True)
                elif cmd == "revert":
                    self.cmd_revert()
                elif cmd == "show":
                    print(self.patch)
                elif cmd == "render":
                    self.cmd_render(float(args[0]) if args else None)
                elif cmd == "save":
                    self.patch.save(args[0])
                elif cmd == "load":
                    self.patch = Patch.load(args[0], self.features, self.segmentations, self.tempo, self.fps)
                else:
                    print(f"unknown command {cmd!r} — type help")
            except Exception as e:
                print(f"error: {e}")
