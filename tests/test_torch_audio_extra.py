"""The small leftovers of ported modules against the JAX package, on the CPU:
the tensor forms of ``audio/convert.py``, the 2-D median helpers,
``video_absdiff``, ``utils/profiling.py``, ``audio/extra.py``, the parity
CLI and the subpackages' re-exports.

Tolerances: the median helpers are bit-equal (a median selects);
``video_absdiff``, the convert helpers and ``tempogram_ratio`` rtol 1e-5;
``hpcp`` and ``raw_hpcp`` within 1e-4 of the largest value (the port's
pitch profile scatters the peaks where JAX multiplies by a one-hot: the
same sums in another order).  The inputs are tones whose spectral peaks
lie away from a constant-Q bin's half-way point, so that both packages
round each peak to the same bin.
"""
import ast
import importlib
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssar_tpu_torch.audio import convert as t_convert
from ssar_tpu_torch.audio import extra as t_extra
from ssar_tpu_torch.utils import profiling
from torch_parity import close, one_torch_thread  # noqa: F401

t_absdiff = importlib.import_module("ssar_tpu_torch.ops.absdiff")
t_median = importlib.import_module("ssar_tpu_torch.ops.median")

j_convert = importlib.import_module("ssar_tpu.audio.convert")
j_extra = importlib.import_module("ssar_tpu.audio.extra")
j_absdiff = importlib.import_module("ssar_tpu.ops.absdiff")
j_median = importlib.import_module("ssar_tpu.ops.median")

ROOT = Path(__file__).resolve().parents[1]
SR = 24576


def _saw(f0: float, seconds: float, n_harm: int = 5, noise: float = 1e-3) -> np.ndarray:
    t = np.arange(int(SR * seconds)) / SR
    saw = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in range(1, n_harm + 1))
    au = 0.4 * saw / np.abs(saw).max() + noise * np.random.RandomState(0).randn(len(t))
    return au.astype(np.float32)


# ---------------------------------------------------------------- convert --
@pytest.mark.parametrize("name,kwargs", [("hz_to_mel", {}), ("hz_to_mel", {"htk": True}), ("mel_to_hz", {}),
                                         ("mel_to_hz", {"htk": True}), ("hz_to_octs", {}),
                                         ("hz_to_octs", {"tuning": 0.3, "bins_per_octave": 36})])
def test_convert_tensor_forms_match_jax(name, kwargs):
    x = np.geomspace(20.0, 11025.0, 257).astype(np.float32) if name != "mel_to_hz" else \
        np.linspace(0.0, 45.0, 257).astype(np.float32)
    want = np.asarray(getattr(j_convert, name)(jnp.asarray(x), **kwargs))
    got = getattr(t_convert, name)(torch.as_tensor(x), **kwargs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert float(getattr(t_convert, name)(float(x[10]), **kwargs)) == pytest.approx(float(want[10]), rel=1e-5)


def test_note_to_hz():
    assert t_convert.note_to_hz("C1") == j_convert.note_to_hz("C1") == t_convert.C1_HZ
    with pytest.raises(ValueError, match="C1"):
        t_convert.note_to_hz("A4")


# ----------------------------------------------------------- median, absdiff --
@pytest.mark.parametrize("axis_name", ["freq", "time"])
@pytest.mark.parametrize("ks", [31, 7])
def test_median_filter2d_bit_equal_to_jax(rng, axis_name, ks):
    S = rng.rand(41, 37).astype(np.float32)
    got = getattr(t_median, f"median_filter2d_{axis_name}")(torch.as_tensor(S), ks)
    want = np.asarray(getattr(j_median, f"median_filter2d_{axis_name}")(jnp.asarray(S), ks))
    np.testing.assert_array_equal(got.numpy(), want)
    axis = 0 if axis_name == "freq" else 1
    assert torch.equal(got, t_median.median_filter_plain(torch.as_tensor(S), ks, axis))


def test_video_absdiff_matches_jax(rng):
    video = rng.rand(9, 3, 6, 5).astype(np.float32)
    got = t_absdiff.video_absdiff(torch.as_tensor(video))
    want = np.asarray(j_absdiff.video_absdiff(jnp.asarray(video)))
    assert got.shape == want.shape == (9, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert torch.equal(got[:, 0], t_absdiff.absdiff_plain(torch.as_tensor(video)))


# -------------------------------------------------------------- profiling --
def test_stage_timer_and_autotune_record_a_failing_config():
    timer = profiling.StageTimer()
    x = torch.arange(10.0)
    for _ in range(2):
        with timer.stage("sum", sync=x):
            x.sum()
    with timer.stage("noop"):
        pass
    assert [len(v) for v in timer.records.values()] == [2, 1]
    assert "sum" in timer.summary() and "noop" in timer.summary()

    def make(scale):
        if scale < 0:
            raise ValueError("negative scale")
        return lambda a: a * scale

    best, results = profiling.autotune(make, [{"scale": -1}, {"scale": 2}], (x,), iters=2, warmup=1, device="cpu")
    assert best == {"scale": 2}
    assert results[0]["time"] == float("inf") and "negative scale" in results[0]["error"]
    assert np.isfinite(results[1]["time"]) and "error" not in results[1]


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as d:
        torch.ones(8).sum()
    files = list(Path(d).glob("trace-*.json"))
    assert len(files) == 1
    assert "traceEvents" in json.loads(files[0].read_text())


def test_autotune_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.autotune(lambda: (lambda: None), [{}], ())


# ------------------------------------------------------------------ extra --
def test_spectral_peaks_and_hpcp_match_jax():
    au = _saw(440.0, 1.0)
    S = np.abs(np.fft.rfft(au[: 2048 * 12].reshape(12, 2048) * np.hanning(2048), axis=1)).T.astype(np.float32)
    jf, jm, jk = (np.asarray(a) for a in j_extra.spectral_peaks(jnp.asarray(S), SR))
    tf, tm, tk = t_extra.spectral_peaks(torch.as_tensor(S), SR)
    np.testing.assert_array_equal(tk.numpy(), jk)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=1e-5)
    assert torch.equal(tm, torch.as_tensor(S))

    want = np.asarray(j_extra.hpcp(jnp.asarray(au), SR))
    got = t_extra.hpcp(torch.as_tensor(au), SR)
    assert want.shape == (24, 12)
    close(got, want, 1e-4, "hpcp")
    assert np.bincount(got.numpy().argmax(1)).argmax() == 0   # 440 Hz == f_ref -> class 0


@pytest.mark.parametrize("kwargs", [{}, {"whitening": False}, {"norm_frames": True, "final_thr": 0.1}])
def test_raw_hpcp_matches_jax(kwargs):
    au = _saw(220.0, 1.0)
    want = np.asarray(j_extra.raw_hpcp(jnp.asarray(au), SR, **kwargs))
    got = t_extra.raw_hpcp(torch.as_tensor(au), SR, **kwargs)
    assert want.shape == (48, 12)
    close(got, want, 1e-4, f"raw_hpcp {kwargs}")
    if not kwargs:
        assert np.bincount(got.numpy().argmax(1), minlength=12).argmax() == 9  # A3 folds to class A


def test_tempogram_ratio_matches_jax(rng):
    env = (0.05 * rng.randn(SR * 3)).astype(np.float32)
    env[:: SR // 2] += 2.0  # 120 bpm
    for bpm, n in ((120.0, 8), (97.0, 5)):
        want = np.asarray(j_extra.tempogram_ratio(jnp.asarray(env), SR, bpm, n))
        got = t_extra.tempogram_ratio(torch.as_tensor(env), SR, bpm, n)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        if bpm == 120.0:
            assert int(got.argmax()) == 4  # ratio 1.0 dominates


# ------------------------------------------------------------- parity CLI --
def test_parity_cli_runs_on_the_cpu(capsys):
    from ssar_tpu_torch.audio.parity import main

    main(["--seconds", "2", "--trials", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.strip()]
    assert len(lines) == 11  # header + 10 features
    assert "FAIL" not in out
    for row in ("rms", "melspec"):
        line = next(ln for ln in lines if ln.startswith(row))
        assert "shape" not in line
        assert float(line.split("/")[-1]) < 1e-2


# -------------------------------------------------------------- re-exports --
PALLAS_NAMES = {"absdiff_pallas": "absdiff", "absdiff_ref": "absdiff_plain",
                "sliding_median_lastaxis": "sliding_median_cuda",
                "s4d_vandermonde_pallas": "s4d_vandermonde", "s4d_vandermonde_ref": "s4d_vandermonde_plain"}


def _exported(init: Path) -> list[str]:
    return [a.asname or a.name for node in ast.parse(init.read_text()).body
            if isinstance(node, ast.ImportFrom) for a in node.names]


@pytest.mark.parametrize("pkg", ["audio", "ops", "models", "gan"])
def test_reexports_cover_the_jax_packages(pkg):
    port = importlib.import_module(f"ssar_tpu_torch.{pkg}")
    names = _exported(ROOT / "ssar_tpu" / pkg / "__init__.py")
    assert len(names) > 5
    missing = [n for n in names if not hasattr(port, PALLAS_NAMES.get(n, n))]
    assert not missing, f"ssar_tpu_torch.{pkg} lacks {missing}"
    if pkg == "ops":
        for jax_name, port_name in PALLAS_NAMES.items():
            assert jax_name in port.__doc__ and port_name in port.__doc__


def test_subpackages_import_alone_without_building_a_kernel():
    """Each subpackage imported first in a fresh interpreter (an import cycle
    shows only then), and no kernel built."""
    code = """
import importlib, sys
for pkg in ("models", "gan", "audio", "metrics.context_fid"):
    for m in [m for m in sys.modules if m.startswith("ssar_tpu_torch")]:
        del sys.modules[m]
    importlib.import_module("ssar_tpu_torch." + pkg)
    assert not importlib.import_module("ssar_tpu_torch.ops._build").build_log, pkg
assert "jax" not in sys.modules
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
