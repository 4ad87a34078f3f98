"""The raw streaming cache, its memory-mapped loader and the grain loader
(``ssar_tpu_torch/train/data.py``, ``ssar_tpu_torch/utils/native.py``)
against the JAX package's, on the CPU.

Everything here is exact: the cache files are byte-equal, and batches equal
bit for bit (they are copies of the same float32 rows).
"""
import importlib

import numpy as np
import pytest
import torch

from ssar_tpu_torch.train import data as t_data
from ssar_tpu_torch.train import train as t_train
from ssar_tpu_torch.utils import native as t_native
from torch_parity import one_torch_thread  # noqa: F401

j_data = importlib.import_module("ssar_tpu.train.data")
j_native = importlib.import_module("ssar_tpu.utils.native")

L = 24
LENGTHS = {"train": [40, 56, 24], "val": [30]}


def _tracks(split: str, seed: int):
    rng = np.random.RandomState(seed)
    T = sum(LENGTHS[split])
    feats = rng.randn(T, 59).astype(np.float32)
    lats = rng.randn(T, 18, 512).astype(np.float32)
    noises = [rng.randn(T, s, s).astype(np.float32) for s in (4, 8, 16, 32)]
    return feats, lats, noises


def _write(module, root, windowed: bool = False):
    """Both splits as a raw cache (or as the windowed shards of the same tracks)."""
    root.mkdir(parents=True, exist_ok=True)
    for seed, split in enumerate(("train", "val")):
        feats, lats, noises = _tracks(split, seed)
        if not windowed:
            module.write_raw_cache(root, split, feats, lats, noises, L, LENGTHS[split])
            continue
        arrays = [feats, lats, *noises]
        cuts = np.cumsum([0] + LENGTHS[split])
        shards = [np.concatenate([t_data.overlapping_slices(a[lo:hi], L) for lo, hi in zip(cuts, cuts[1:])])
                  for a in arrays]
        names = ["features", "latents"] + [f"noise{s}" for s in (4, 8, 16, 32)]
        for name, shard in zip(names, shards):
            np.save(root / f"{split}_{name}.npy", shard)
    mean, std = t_data.compute_stats(_tracks("train", 0)[0])
    np.save(root / "train_mean.npy", mean)
    np.save(root / "train_std.npy", std)
    return root


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    base = tmp_path_factory.mktemp("caches")
    return {"port": _write(t_data, base / "port"), "jax": _write(j_data, base / "jax"),
            "windowed": _write(t_data, base / "windowed", windowed=True)}


def test_write_raw_cache_writes_the_jax_files(caches):
    names = sorted(p.name for p in caches["jax"].iterdir())
    assert names == sorted(p.name for p in caches["port"].iterdir()) and "train_starts.npy" in names
    for name in names:
        assert (caches["port"] / name).read_bytes() == (caches["jax"] / name).read_bytes(), name
    # windows start every L // 4 frames and never cross a track boundary
    assert np.load(caches["port"] / "train_starts.npy").tolist() == [0, 6, 12, 40, 46, 52, 58, 64, 70, 96]


@pytest.mark.parametrize("seed,batch,shuffle", [(0, 4, True), (3, 3, True), (0, 5, False)])
def test_mmap_window_dataset_matches_jax(caches, seed, batch, shuffle):
    got = t_data.load_cached(caches["port"], "train")
    want = j_data.load_cached(caches["jax"], "train")
    assert isinstance(got, t_data.MmapWindowDataset) and len(got) == len(want) == 10
    g, w = got.batches(batch, seed=seed, shuffle=shuffle), want.batches(batch, seed=seed, shuffle=shuffle)
    for _ in range(5):   # past the end of the first epoch
        for a, b in zip(next(g), next(w)):
            assert a.dtype == np.float32 and np.array_equal(a, b)


def test_raw_batches_equal_the_windowed_shards(caches):
    """Window i is the same rows in both layouts, so the trainer's index stream
    gathers the same batches from either."""
    raw = t_data.load_cached(caches["port"], "train")
    shards = t_data.load_cached(caches["windowed"], "train")
    assert isinstance(shards, t_data.WindowDataset) and len(shards) == len(raw)
    for a, b in zip(raw.batches_from(raw.index_batches(4, seed=42)),
                    shards.batches_from(shards.index_batches(4, seed=42))):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        break
    for i in range(len(raw)):
        assert all(np.array_equal(x, y) for x, y in zip(raw.window(i), shards.window(i)))
    # one epoch, a split smaller than the batch wrap-padded to one batch, as WindowDataset does
    val = t_data.load_cached(caches["port"], "val")
    epoch = list(val.batches(4, shuffle=False, loop=False))
    assert len(val) == 2 and len(epoch) == 1 and np.array_equal(epoch[0][0][2], epoch[0][0][0])


def test_grain_loader_matches_jax(caches):
    """The JAX package's grain loader reads the windowed shards only (its
    source indexes ``MmapWindows``, which a raw cache cannot serve); the
    port's gives the same batches from either layout of the same tracks."""
    pytest.importorskip("grain")
    for layout in ("port", "windowed"):
        got = t_data.grain_loader(str(caches[layout]), "train", batch_size=4, seed=1)
        want = j_data.grain_loader(str(caches["windowed"]), "train", batch_size=4, seed=1)
        for _ in range(3):
            for a, b in zip(next(got), next(want)):
                assert np.array_equal(np.asarray(a), np.asarray(b))


def test_grain_loader_falls_back_without_grain(caches, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "grain", None)
    monkeypatch.setitem(sys.modules, "grain.python", None)
    got = t_data.grain_loader(str(caches["port"]), "train", batch_size=4, seed=2)
    want = t_data.load_cached(caches["port"], "train").batches(4, seed=2)
    for _ in range(3):
        assert all(np.array_equal(a, b) for a, b in zip(next(got), next(want)))


def test_mmap_windows_match_jax_and_reject_out_of_range(tmp_path):
    arr = np.random.RandomState(0).randn(200, 3, 5).astype(np.float32)
    np.save(tmp_path / "x.npy", arr)
    got, want = t_native.MmapWindows(tmp_path / "x.npy", 16), j_native.MmapWindows(tmp_path / "x.npy", 16)
    starts = np.array([0, 7, 100, 184])
    assert np.array_equal(got.gather(starts), want.gather(starts))
    assert np.array_equal(got.gather(starts), np.stack([arr[s : s + 16] for s in starts]))
    for bad in ([185], [-1], [0, 300]):
        with pytest.raises(IndexError):
            got.gather(np.array(bad))
        with pytest.raises(IndexError):
            want.gather(np.array(bad))
    got.close()
    want.close()
    np.save(tmp_path / "d.npy", arr.astype(np.float64))
    with pytest.raises(ValueError):
        t_native.MmapWindows(tmp_path / "d.npy", 4)


def test_native_quantiles_match_jax():
    x = np.random.RandomState(1).randn(1001, 7).astype(np.float32)
    for q in (0.0, 0.1, 0.5, 0.975, 1.0):
        assert t_native.quantile(x, q) == j_native.quantile(x, q)
        assert np.array_equal(t_native.quantile_cols(x, q), j_native.quantile_cols(x, q))
    assert np.array_equal(t_native.standardize(x), j_native.standardize(x))


def test_native_library_lands_in_build_keyed_by_the_source():
    path = t_native.build("window_loader")
    assert path.parent == t_native.ROOT / "build" / "native" and path.suffix == ".so"
    assert path == t_native.library_path("window_loader") and path.exists()
    assert t_native.library_path("window_loader") != t_native.library_path("efficient_quantile")


def test_trainer_trains_on_the_raw_cache_as_on_the_shards(caches, tmp_path):
    """``train.main`` on the raw cache (host-streamed through the native
    loader) ends where it ends on the windowed shards of the same tracks
    (resident), parameter for parameter."""
    flags = ["--decoder", "fixed", "--backbone", "gru", "--loss", "ssabsdiff", "--hidden_size", "4",
             "--num_layers", "1", "--duration", "1", "--batch_size", "4", "--n_examples", "12",
             "--eval_every", "8", "--no-render_at_ckpt", "--no-fcd", "--device", "cpu"]
    runs = {}
    for layout in ("port", "windowed"):
        runs[layout], _ = t_train.main(flags + ["--cache_dir", str(caches[layout]),
                                                "--out_dir", str(tmp_path / layout)])
    want = torch.load(t_train._latest_checkpoint(runs["windowed"]), weights_only=True)["params"]
    got = torch.load(t_train._latest_checkpoint(runs["port"]), weights_only=True)["params"]
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert (runs["port"] / "metrics.csv").read_text() == (runs["windowed"] / "metrics.csv").read_text()
    pytest.importorskip("matplotlib")
    assert sorted(p.name for p in runs["port"].glob("diagnostics_*.png")) == \
        ["diagnostics_00000000.png", "diagnostics_00000008.png"]
