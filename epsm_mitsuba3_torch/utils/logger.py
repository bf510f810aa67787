"""Experiment logger (counterpart of ``utils/logger.py``, the reference's
``EPSM/utils/logger.py``).

Keeps each iteration's artifacts under one directory: images (.npy,
.png), parameter dumps, scalar metrics as JSONL, one mp4 video a stream
(EPSM/utils/logger.py:50-66 ``add_image(type="video")``) and TensorBoard
scalars and images.  Without cv2 or imageio a video stream is written as
numbered PNG frames, and without TensorBoard nothing is mirrored there,
so a headless run needs neither.  Images and parameters may be tensors on
any device; they are copied to the host.
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch


def host_array(x) -> np.ndarray:
    """``x`` (a tensor on any device, an array or a number) as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Logger:
    def __init__(self, path: str, exp_name: str = "", tensorboard=False,
                 video_fps: float = 24.0):
        self.dir = os.path.join(path, exp_name) if exp_name else path
        os.makedirs(self.dir, exist_ok=True)
        os.makedirs(os.path.join(self.dir, "params"), exist_ok=True)
        os.makedirs(os.path.join(self.dir, "images"), exist_ok=True)
        self._metrics = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self._videos: Dict[str, object] = {}
        self._video_fps = float(video_fps)
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=self.dir)
            except ImportError:
                self._tb = None

    # -- video streams (EPSM logger add_image(type="video")) ---------------
    def add_image(self, name: str, content, step: int = 0,
                  type: str = "video") -> None:
        """Append a frame to the stream ``name``.

        ``type="video"``: one mp4 a stream (24 fps by default); without a
        video backend, numbered PNG frames.  ``type="image"``: one
        numbered PNG.  Mirrored to TensorBoard when it is on."""
        from ..core.spectrum import to_bitmap_u8
        arr = to_bitmap_u8(host_array(content).astype(np.float32))
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, -1)
        arr = arr[..., :3]
        if self._tb is not None:
            self._tb.add_image(name, arr, step, dataformats="HWC")
        if type != "video":
            _write_png(os.path.join(self.dir, "images",
                                    f"{name}_{step:05d}"), arr)
            return
        if name not in self._videos:
            self._videos[name] = _open_video(
                os.path.join(self.dir, name.replace(" ", "_") + ".mp4"),
                arr.shape[1], arr.shape[0], self._video_fps)
        vw = self._videos[name]
        if vw is None:   # no backend: numbered frames
            _write_png(os.path.join(self.dir, "images",
                                    f"{name}_{step:05d}"), arr)
        else:
            vw.append(arr)

    def save_img(self, name: str, img) -> str:
        """A PNG through the sRGB encoder (logger.py save_img)."""
        from ..core.spectrum import to_bitmap_u8
        arr = to_bitmap_u8(host_array(img).astype(np.float32))
        out = os.path.join(self.dir, "images", name)
        _write_png(out, arr)
        return out

    def save_npy(self, name: str, arr) -> str:
        out = os.path.join(self.dir, "images", name)
        np.save(out, host_array(arr))
        return out

    def add_params(self, it: int, params: Dict[str, np.ndarray]):
        np.save(os.path.join(self.dir, "params", f"param{it}.npy"),
                np.asarray({k: host_array(v) for k, v in params.items()},
                           dtype=object), allow_pickle=True)

    def add_metric(self, it: int, **kwargs):
        rec = {"it": it}
        rec.update({k: float(v) for k, v in kwargs.items()})
        self._metrics.write(json.dumps(rec) + "\n")
        self._metrics.flush()
        if self._tb is not None:
            for k, v in kwargs.items():
                self._tb.add_scalar(k, float(v), it)

    def close(self):
        self._metrics.close()
        for vw in self._videos.values():
            if vw is not None:
                vw.close()
        self._videos.clear()
        if self._tb is not None:
            self._tb.close()


class _Cv2Video:
    def __init__(self, path, w, h, fps):
        import cv2
        self._cv2 = cv2
        self._w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                                  fps, (w, h), True)

    def append(self, rgb_u8):
        self._w.write(self._cv2.cvtColor(rgb_u8, self._cv2.COLOR_RGB2BGR))

    def close(self):
        self._w.release()


class _ImageioVideo:
    def __init__(self, path, fps):
        import imageio
        self._w = imageio.get_writer(path, fps=fps)

    def append(self, rgb_u8):
        self._w.append_data(rgb_u8)

    def close(self):
        self._w.close()


def _open_video(path, w, h, fps):
    """A cv2 writer, else an imageio writer, else None (numbered
    frames)."""
    try:
        return _Cv2Video(path, w, h, fps)
    except Exception:    # no cv2, or no codec: try the next backend
        pass
    try:
        return _ImageioVideo(path, fps)
    except Exception:    # no imageio, or no ffmpeg plugin: frames
        return None


def _write_png(path: str, arr: np.ndarray):
    """A minimal RGB8 PNG writer (zlib and struct, no image library)."""
    import struct
    import zlib

    if arr.ndim == 2:
        arr = np.stack([arr] * 3, -1)
    h, w = arr.shape[:2]
    arr = arr[..., :3].astype(np.uint8)
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    if not path.endswith(".png"):
        path += ".png"
    with open(path, "wb") as f:
        f.write(png)
