"""The check sees a broken timed path: a whole run at a small size on the
CPU (the look for a card skipped) with a fault planted in the port
underneath, and ``correct`` has to come out false.

Faults, each where its answer is produced: frames that stay the first
batch's (a step that returns its state unchanged); half of each batch not
rendered, its other half repeated (half of the batch left out); frames,
latents and features altered.  One chip: no exchange between chips to
leave out."""
import pytest
import torch

import port_bench.run as run

from .conftest import LONGFORM, PATCH, small


def plant(monkeypatch, fault: str):
    from ssar_tpu_torch.gan import wrapper

    call = wrapper.StyleGAN2Synthesizer.__call__
    first: dict = {}

    def synth(self, latents, *a, **kw):
        out = call(self, latents, *a, **kw)
        if fault == "stale":
            first.setdefault(id(self), out)
            return first[id(self)][: out.shape[0]]
        if fault == "half_batch":
            h = out.shape[0] // 2
            return torch.cat([out[: out.shape[0] - h], out[: h]])
        return out + 0.05   # frames altered

    if fault in ("stale", "half_batch", "frames"):
        monkeypatch.setattr(wrapper.StyleGAN2Synthesizer, "__call__", synth)
    elif fault == "latents":
        from ssar_tpu_torch.generate import audio2video, patch

        react, forward = audio2video.react, patch.Patch.forward
        monkeypatch.setattr(audio2video, "react", lambda *a, **k: (lambda r: (r[0] * 1.02, r[1]))(react(*a, **k)))
        monkeypatch.setattr(patch.Patch, "forward",
                            lambda self, *a, **k: (lambda r: (r[0] * 1.02, r[1]))(forward(self, *a, **k)))
    elif fault == "features":
        from ssar_tpu_torch.generate import audio2video, sample

        feats, mir = audio2video.audio2features, sample.retrieve_music_information
        monkeypatch.setattr(audio2video, "audio2features", lambda *a, **k: feats(*a, **k) * 1.001)
        monkeypatch.setattr(sample, "retrieve_music_information", lambda *a, **k: (
            lambda r: ({n: f * 1.001 for n, f in r[0].items()}, r[1], r[2]))(mir(*a, **k)))


@pytest.mark.parametrize("workload", [LONGFORM, PATCH])
@pytest.mark.parametrize("fault", ["stale", "half_batch", "frames", "latents", "features"])
def test_fault_is_not_correct(monkeypatch, workload, fault):
    plant(monkeypatch, fault)
    config, mix = small(workload, seconds=2.0)
    result = run.run_cell(workload, 2**33 + 9, 60.0, False, device="cpu", config=config, mix=mix)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("workload", [LONGFORM, PATCH])
def test_sound_run_is_correct(workload):
    config, mix = small(workload, seconds=2.0)
    result = run.run_cell(workload, 2**33 + 9, 60.0, False, device="cpu", config=config, mix=mix)
    assert result["correct"] is True, result["checks"]
