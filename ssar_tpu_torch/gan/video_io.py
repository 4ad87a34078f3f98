"""Host-side video muxing: VideoWriter context manager + write_video.

A copy of ``ssar_tpu/gan/video_io.py`` (numpy / cv2 / ffmpeg only), kept in
the port so that it imports nothing of the JAX package.  Frames are encoded
with cv2 (mp4v), imported lazily: a machine without cv2 can still import this
module and render through another frame writer, such as ``Y4MWriter``
(uncompressed I420, numpy only).  When an ``ffmpeg``
executable is available the audio track is muxed in a post-pass, otherwise
the request is recorded in a sidecar ``.audio.json``.

Device -> host transfer is double-buffered by the caller (gan/render.py);
this module only consumes ready numpy frames.
"""
from __future__ import annotations

import json
import shutil
import subprocess
from pathlib import Path

import numpy as np


def _have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


class VideoWriter:
    """Context manager writing (H, W, 3) float [0,1] or uint8 frames to mp4.

    Mirrors maua's API: VideoWriter(output_file, output_size=(W, H), fps,
    audio_file, audio_offset, audio_duration) with .write(frame).
    """

    def __init__(self, output_file: str, output_size: tuple[int, int], fps: float = 24,
                 audio_file: str | None = None, audio_offset: float = 0,
                 audio_duration: float | None = None):
        self.output_file = str(output_file)
        self.output_size = tuple(int(x) for x in output_size)  # (W, H)
        self.fps = fps
        self.audio_file = audio_file
        self.audio_offset = audio_offset
        self.audio_duration = audio_duration
        self._writer = None
        self.frames_written = 0

    def __enter__(self):
        import cv2

        Path(self.output_file).parent.mkdir(parents=True, exist_ok=True)
        fourcc = cv2.VideoWriter_fourcc(*"mp4v")
        self._writer = cv2.VideoWriter(self.output_file, fourcc, self.fps, self.output_size)
        if not self._writer.isOpened():
            raise RuntimeError(f"cv2.VideoWriter failed to open {self.output_file}")
        return self

    def write(self, frame) -> None:
        """frame: (H, W, 3) RGB, float in [0,1] or uint8; or (1, H, W, 3)."""
        import cv2

        frame = np.asarray(frame)
        if frame.ndim == 4:
            frame = frame[0]
        if frame.dtype != np.uint8:
            frame = (np.clip(frame, 0.0, 1.0) * 255).astype(np.uint8)
        if (frame.shape[1], frame.shape[0]) != self.output_size:
            frame = cv2.resize(frame, self.output_size, interpolation=cv2.INTER_AREA)
        self._writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        self.frames_written += 1

    def write_i420(self, frame) -> None:
        """frame: (H*3//2, W) uint8 I420 (see render.rgb_to_i420) at
        exactly the writer's output size — the half-size device->host path."""
        import cv2

        frame = np.asarray(frame)
        if frame.ndim == 3:
            frame = frame[0]
        W, H = self.output_size
        if frame.shape != (H * 3 // 2, W):
            raise ValueError(f"I420 frame {frame.shape} != output size {(H * 3 // 2, W)}")
        self._writer.write(cv2.cvtColor(frame, cv2.COLOR_YUV2BGR_I420))
        self.frames_written += 1

    def __exit__(self, exc_type, exc, tb):
        if self._writer is not None:
            self._writer.release()
        if exc_type is None and self.audio_file:
            self._mux_audio()
        return False

    def _mux_audio(self) -> None:
        if _have_ffmpeg():
            tmp = self.output_file + ".muxing.mp4"
            cmd = ["ffmpeg", "-y", "-i", self.output_file]
            if self.audio_offset:
                cmd += ["-ss", str(self.audio_offset)]
            cmd += ["-i", self.audio_file]
            if self.audio_duration is not None:
                cmd += ["-t", str(self.audio_duration)]
            cmd += ["-map", "0:v", "-map", "1:a", "-c:v", "copy", "-shortest", tmp]
            try:
                subprocess.run(cmd, check=True, capture_output=True)
                Path(tmp).replace(self.output_file)
            except Exception:
                Path(tmp).unlink(missing_ok=True)
        else:
            sidecar = Path(self.output_file).with_suffix(".audio.json")
            sidecar.write_text(json.dumps({
                "audio_file": str(self.audio_file),
                "audio_offset": self.audio_offset,
                "audio_duration": self.audio_duration,
            }))


class Y4MWriter:
    """Context manager writing uncompressed I420 frames to a YUV4MPEG2 (.y4m)
    file, with numpy only: the frame writer for machines without cv2.
    Takes the (H*3//2, W) uint8 frames of ``render.rgb_to_i420``."""

    def __init__(self, output_file: str, output_size: tuple[int, int], fps: int = 24):
        self.output_file = str(output_file)
        self.output_size = tuple(int(x) for x in output_size)  # (W, H)
        self.fps = int(fps)
        self._f = None
        self.frames_written = 0

    def __enter__(self):
        Path(self.output_file).parent.mkdir(parents=True, exist_ok=True)
        W, H = self.output_size
        self._f = open(self.output_file, "wb")
        self._f.write(f"YUV4MPEG2 W{W} H{H} F{self.fps}:1 Ip A1:1 C420jpeg\n".encode())
        return self

    def write_i420(self, frame) -> None:
        frame = np.asarray(frame)
        W, H = self.output_size
        if frame.shape != (H * 3 // 2, W) or frame.dtype != np.uint8:
            raise ValueError(f"I420 frame {frame.shape} {frame.dtype} != uint8 {(H * 3 // 2, W)}")
        self._f.write(b"FRAME\n")
        self._f.write(np.ascontiguousarray(frame).tobytes())
        self.frames_written += 1

    def write(self, frame) -> None:
        raise ValueError("Y4MWriter takes I420 frames (write_i420): use an output size with H % 4 == 0")

    def __exit__(self, exc_type, exc, tb):
        if self._f is not None:
            self._f.close()
        return False


def write_video(tensor, output_file: str, fps: float = 24, audio_file: str | None = None) -> None:
    """(T, H, W, 3) [0,1] array -> mp4 (maua `write_video` equivalent)."""
    tensor = np.asarray(tensor)
    if tensor.ndim == 4 and tensor.shape[1] == 3 and tensor.shape[-1] != 3:
        tensor = tensor.transpose(0, 2, 3, 1)  # accept NCHW too
    T, H, W, _ = tensor.shape
    with VideoWriter(output_file, (W, H), fps=fps, audio_file=audio_file) as v:
        for t in range(T):
            v.write(tensor[t])
