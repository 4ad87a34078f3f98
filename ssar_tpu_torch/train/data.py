"""Data pipeline: preprocess-once feature/latent windows + host-side loader.

Counterpart of ``ssar_tpu/train/data.py`` (numpy, so the same seeds give the
same arrays as the JAX package):
- ``preprocess_directory``: per track, load audio, run the port's
  ``audio2features`` on the device, load the ``{track}.npy`` W+ targets and
  4 noise pyramids, slice into 4x-overlapping L-frame windows and write
  ``.npy`` shards, plus the train mean/std;
- the per-file 80/20 split with RandomState(42);
- ``WindowDataset``: shuffled epoch iterators, or index vectors for the
  device-resident path (``to_device`` puts its arrays on the card);
- ``synthetic_dataset`` backs the smoke paths without a corpus on disk;
- the raw streaming cache: ``write_raw_cache`` stores unwindowed
  track-concatenated arrays and the window starts, and ``MmapWindowDataset``
  gathers each batch's windows from memory maps through the C++ loader
  (``utils/native.py``); ``load_cached`` opens either layout;
- ``grain_loader``: a grain pipeline over either cache, sharded by the
  ``torch.distributed`` rank (the prefetch iterator where grain is missing).
"""
from __future__ import annotations

import json
import queue as queue_mod
import threading
from pathlib import Path

import numpy as np
import torch

from ..utils.device import resolve_device


def overlapping_slices(arr: np.ndarray, length: int, overlap: int = 4) -> np.ndarray:
    """(T, ...) -> (n, length, ...) windows with stride length // overlap."""
    stride = length // overlap
    n = max(0, (arr.shape[0] - length) // stride + 1)
    return np.stack([arr[i * stride : i * stride + length] for i in range(n)]) if n else \
        np.zeros((0, length) + arr.shape[1:], arr.dtype)


def load_audio(path: str):
    """Mono float32 waveform + sr: wav via scipy, then soundfile if importable,
    then an ffmpeg subprocess piping f32le PCM, else a clear error."""
    from scipy.io import wavfile

    p = Path(path)
    if p.suffix.lower() == ".wav":
        sr, data = wavfile.read(p)
        data = data.astype(np.float32)
        if data.dtype != np.float32 or np.abs(data).max() > 2.0:
            data = data / 32768.0
        if data.ndim == 2:
            data = data.mean(1)
        return data, sr

    try:
        import soundfile as sf

        data, sr = sf.read(str(p), dtype="float32", always_2d=True)
        return data.mean(1), int(sr)
    except ImportError:
        pass

    data_sr = _ffmpeg_decode(p)
    if data_sr is not None:
        return data_sr
    raise ValueError(f"unsupported audio format {p.suffix}: install soundfile or ffmpeg, or convert to wav")


def _ffmpeg_decode(p: Path, sr: int = 44100):
    """Decode any container to mono float32 PCM via an ffmpeg subprocess
    (None if ffmpeg is not on PATH)."""
    import shutil
    import subprocess

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        return None
    proc = subprocess.run(
        [ffmpeg, "-v", "error", "-i", str(p), "-f", "f32le", "-acodec", "pcm_f32le",
         "-ac", "1", "-ar", str(sr), "pipe:1"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, check=False,
    )
    if proc.returncode != 0:
        raise ValueError(f"ffmpeg failed to decode {p}: {proc.stderr.decode(errors='replace')[:500]}")
    return np.frombuffer(proc.stdout, dtype=np.float32).copy(), sr


class WindowDataset:
    """In-memory windowed dataset of (features, latents, n4, n8, n16, n32)."""

    def __init__(self, features, latents, noises):
        self.features = features  # (N, L, 59)
        self.latents = latents    # (N, L, n_ws, 512)
        self.noises = noises      # list of 4 (N, L, s, s)

    def __len__(self):
        return len(self.features)

    @property
    def arrays(self) -> tuple:
        return (self.features, self.latents, *self.noises)

    def to_device(self, device: str | torch.device | None = None) -> tuple:
        """The six arrays as float32 tensors on `device` (the CUDA device
        unless given), for the device-resident training path."""
        device = resolve_device(device)
        # a copy: the arrays may be read-only memory maps of the cache
        return tuple(torch.tensor(np.asarray(a), dtype=torch.float32, device=device) for a in self.arrays)

    def index_batches(self, batch_size: int, seed: int = 0):
        """Infinite stream of index vectors, in the order ``batches`` visits."""
        idx = np.arange(len(self))
        rng = np.random.RandomState(seed)
        if len(idx) < batch_size:
            idx = np.tile(idx, int(np.ceil(batch_size / len(idx))))[:batch_size]
        while True:
            rng.shuffle(idx)
            for i in range(0, len(idx) - batch_size + 1, batch_size):
                yield idx[i : i + batch_size]

    def window(self, i: int) -> tuple:
        """The six arrays of window `i`."""
        return tuple(np.asarray(a[i]) for a in self.arrays)

    def batches_from(self, idx_stream):
        """Materialise batches for a stream of index vectors (the resume path)."""
        for sel in idx_stream:
            yield (self.features[sel], self.latents[sel], *[n[sel] for n in self.noises])

    def batches(self, batch_size: int, seed: int = 0, shuffle: bool = True,
                drop_last: bool = True, loop: bool = True):
        """Batch generator; infinite when ``loop`` (training), one epoch
        otherwise.  Datasets smaller than ``batch_size`` are wrap-padded so a
        full batch always exists."""
        idx = np.arange(len(self))
        rng = np.random.RandomState(seed)
        if len(idx) == 0:
            raise ValueError("empty dataset")
        if len(idx) < batch_size:
            idx = np.tile(idx, int(np.ceil(batch_size / len(idx))))[:batch_size]
        while True:
            if shuffle:
                rng.shuffle(idx)
            for i in range(0, len(idx) - (batch_size - 1 if drop_last else 0), batch_size):
                sel = idx[i : i + batch_size]
                yield (self.features[sel], self.latents[sel], *[n[sel] for n in self.noises])
            if not loop:
                return


def prefetch(gen, depth: int = 2):
    """Host-side prefetch thread."""
    q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
    stop = object()

    def worker():
        for item in gen:
            q.put(item)
        q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            return
        yield item


def synthetic_dataset(n_windows: int = 64, n_frames: int = 192, n_ws: int = 18, seed: int = 42):
    """Feature/latent windows with audio->feature correlation structure:
    latents follow a random linear map of the features plus noise."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(n_windows, n_frames, 59).astype(np.float32)
    r = min(8, (n_frames - 1) // 2)
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / 3.0) ** 2)
    k /= k.sum()
    feats = np.apply_along_axis(lambda s: np.convolve(s, k, mode="same"), 1, feats)
    proj = rng.randn(59, n_ws * 8).astype(np.float32) / np.sqrt(59)
    base = rng.randn(1, 1, n_ws, 512).astype(np.float32)
    directions = rng.randn(n_ws, 8, 512).astype(np.float32) / 8
    coef = feats @ proj
    lat = base + np.einsum("nlwk,wkd->nlwd", coef.reshape(n_windows, n_frames, n_ws, 8), directions)
    noises = [rng.randn(n_windows, n_frames, s, s).astype(np.float32) * 0.1 for s in (4, 8, 16, 32)]
    return WindowDataset(feats, lat.astype(np.float32), noises)


def train_val_split(file_list, seed: int = 42):
    """Per-file 80/20 split, RandomState(42).rand < 0.8."""
    rs = np.random.RandomState(seed)
    mask = rs.rand(len(file_list)) < 0.8
    train = [f for f, m in zip(file_list, mask) if m]
    val = [f for f, m in zip(file_list, mask) if not m]
    return train, val


def compute_stats(features: np.ndarray):
    """Train-set mean/std over (N*L, 59)."""
    flat = features.reshape(-1, features.shape[-1])
    return flat.mean(0), flat.std(0)


def preprocess_directory(in_dir: str, cache_dir: str, dur: int = 8, fps: int = 24, n_ws: int = 18,
                         device: str | torch.device | None = None) -> dict:
    """Cold-cache preprocessing of a corpus directory (audio + .npy targets).

    Expects per track ``{stem}.wav`` plus ``{stem}.npy`` (T, n_ws, 512) W+
    targets and ``{stem}_noise{4,8,16,32}.npy`` pyramids.  Features are
    computed on `device` (the CUDA device unless given).  Writes windowed
    shards + stats to cache_dir.
    """
    from ..audio.features import audio2features

    device = resolve_device(device)
    in_dir, cache_dir = Path(in_dir), Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    L = dur * fps

    tracks = sorted(in_dir.glob("*.wav"))
    train_files, val_files = train_val_split([t.stem for t in tracks])

    meta = {"train": train_files, "val": val_files, "L": L, "fps": fps}
    for split, names in [("train", train_files), ("val", val_files)]:
        feats_all, lats_all, noises_all = [], [], [[] for _ in range(4)]
        for name in names:
            audio, sr = load_audio(in_dir / f"{name}.wav")
            F = audio2features(audio, sr, fps, device=device).cpu().numpy()
            lat = np.load(in_dir / f"{name}.npy").astype(np.float32)
            T = min(len(F), len(lat))
            feats_all.append(overlapping_slices(F[:T], L))
            lats_all.append(overlapping_slices(lat[:T], L))
            for j, s in enumerate((4, 8, 16, 32)):
                nz = np.load(in_dir / f"{name}_noise{s}.npy").astype(np.float32)
                noises_all[j].append(overlapping_slices(nz[:T], L))
        np.save(cache_dir / f"{split}_features.npy", np.concatenate(feats_all))
        np.save(cache_dir / f"{split}_latents.npy", np.concatenate(lats_all))
        for j, s in enumerate((4, 8, 16, 32)):
            np.save(cache_dir / f"{split}_noise{s}.npy", np.concatenate(noises_all[j]))

    train_feats = np.load(cache_dir / "train_features.npy", mmap_mode="r")
    mean, std = compute_stats(np.asarray(train_feats))
    np.save(cache_dir / "train_mean.npy", mean)
    np.save(cache_dir / "train_std.npy", std)
    (cache_dir / "meta.json").write_text(json.dumps(meta))
    return meta


def _shard_options(pygrain):
    """This process's shard: the ``torch.distributed`` rank of its world size
    when a process group is up, else shard 0 of 1."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return pygrain.ShardOptions(dist.get_rank(), dist.get_world_size())
    return pygrain.ShardOptions(0, 1)


def grain_loader(cache_dir: str, split: str, batch_size: int, seed: int = 0, worker_count: int = 0,
                 shuffle: bool = True):
    """Grain input pipeline over a cache (either layout): tuples (features,
    latents, n4, n8, n16, n32) of stacked numpy batches, each process reading
    its shard.  Falls back to the thread-prefetch iterator when grain is not
    importable."""
    try:
        import grain.python as pygrain
    except ImportError:
        ds = load_cached(cache_dir, split)
        yield from prefetch(ds.batches(batch_size, seed=seed, shuffle=shuffle))
        return

    ds = load_cached(cache_dir, split)

    class WindowSource(pygrain.RandomAccessDataSource):
        def __len__(self):
            return len(ds)

        def __getitem__(self, idx):
            return ds.window(idx)

    sampler = pygrain.IndexSampler(num_records=len(ds), shuffle=shuffle, seed=seed,
                                   shard_options=_shard_options(pygrain), num_epochs=None)
    loader = pygrain.DataLoader(data_source=WindowSource(), sampler=sampler, worker_count=worker_count,
                                operations=[pygrain.Batch(batch_size=batch_size, drop_remainder=True)])
    yield from loader


def load_cached(cache_dir: str, split: str):
    """Windowed-shard cache (``preprocess_directory``) -> WindowDataset; raw
    streaming cache (``write_raw_cache``) -> MmapWindowDataset."""
    cache_dir = Path(cache_dir)
    if (cache_dir / f"{split}_starts.npy").exists():
        return MmapWindowDataset(cache_dir, split)
    return WindowDataset(
        np.load(cache_dir / f"{split}_features.npy", mmap_mode="r"),
        np.load(cache_dir / f"{split}_latents.npy", mmap_mode="r"),
        [np.load(cache_dir / f"{split}_noise{s}.npy", mmap_mode="r") for s in (4, 8, 16, 32)],
    )


def write_raw_cache(cache_dir, split: str, features: np.ndarray, latents: np.ndarray, noises: list, L: int,
                    track_lengths: list[int], overlap: int = 4) -> None:
    """Streaming cache layout: unwindowed, track-concatenated float32 arrays
    plus an int64 index of window starts (stride L // overlap, never crossing
    a track boundary): 4x less disk than the windowed shards."""
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    np.save(cache_dir / f"{split}_features_raw.npy", np.ascontiguousarray(features, np.float32))
    np.save(cache_dir / f"{split}_latents_raw.npy", np.ascontiguousarray(latents, np.float32))
    for s, nz in zip((4, 8, 16, 32), noises):
        np.save(cache_dir / f"{split}_noise{s}_raw.npy", np.ascontiguousarray(nz, np.float32))
    starts, off = [], 0
    stride = L // overlap
    for T in track_lengths:
        starts.extend(range(off, off + max(T - L, 0) + 1, stride))
        off += T
    np.save(cache_dir / f"{split}_starts.npy", np.asarray(starts, np.int64))
    (cache_dir / f"{split}_window.json").write_text(json.dumps({"L": L}))


class MmapWindowDataset:
    """On-demand windowed dataset over the raw streaming cache: each batch is
    gathered from the memory-mapped files by the native loader, so a corpus
    larger than RAM streams at copy speed.  It has the index-stream interface
    of ``WindowDataset`` (the trainer streams it from the host)."""

    def __init__(self, cache_dir, split: str):
        from ..utils.native import MmapWindows

        cache_dir = Path(cache_dir)
        self.L = json.loads((cache_dir / f"{split}_window.json").read_text())["L"]
        self.starts = np.load(cache_dir / f"{split}_starts.npy")
        self.features = MmapWindows(cache_dir / f"{split}_features_raw.npy", self.L)
        self.latents = MmapWindows(cache_dir / f"{split}_latents_raw.npy", self.L)
        self.noises = [MmapWindows(cache_dir / f"{split}_noise{s}_raw.npy", self.L) for s in (4, 8, 16, 32)]

    def __len__(self):
        return len(self.starts)

    def gather(self, sel) -> tuple:
        """The six arrays of the windows with indices `sel`."""
        starts = self.starts[np.asarray(sel)]
        return (self.features.gather(starts), self.latents.gather(starts), *[n.gather(starts) for n in self.noises])

    def window(self, i: int) -> tuple:
        """The six arrays of window `i`, without the batch axis."""
        return tuple(a[0] for a in self.gather([int(i)]))

    def index_batches(self, batch_size: int, seed: int = 0):
        """Infinite stream of index vectors, in ``WindowDataset``'s order."""
        return WindowDataset.index_batches(self, batch_size, seed)

    def batches_from(self, idx_stream):
        """Gather the batches of a stream of index vectors."""
        for sel in idx_stream:
            yield self.gather(sel)

    def batches(self, batch_size: int, seed: int = 0, shuffle: bool = True, drop_last: bool = True,
                loop: bool = True):
        """Batch generator, infinite when ``loop``, one epoch otherwise; a
        split smaller than ``batch_size`` is wrap-padded to one full batch, as
        ``WindowDataset.batches`` pads it."""
        idx = np.arange(len(self))
        rng = np.random.RandomState(seed)
        if len(idx) == 0:
            raise ValueError("empty dataset")
        if len(idx) < batch_size:
            idx = np.tile(idx, int(np.ceil(batch_size / len(idx))))[:batch_size]
        while True:
            if shuffle:
                rng.shuffle(idx)
            for i in range(0, len(idx) - (batch_size - 1 if drop_last else 0), batch_size):
                yield self.gather(idx[i : i + batch_size])
            if not loop:
                return
