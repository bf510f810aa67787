"""Bitmap image I/O (counterpart of ``core/bitmap.py``, the reference's
src/core/bitmap.cpp).

Formats: PFM, Radiance RGBE (``.hdr``, read), OpenEXR (scanline, float32
or float16, uncompressed, ZIPS or ZIP; written as float32 ZIP) and
``.npy`` here in numpy; PNG/JPG through PIL, imported inside the call
that needs it.  Images are float32 (H, W, C) numpy arrays in linear RGB;
``write_image`` also takes a tensor, on any device.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from .spectrum import linear_to_srgb, srgb_to_linear


def _numpy(data) -> np.ndarray:
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy()
    return np.asarray(data, np.float32)


class Bitmap:
    """Loaded image: float32 data in linear RGB, shape (H, W, C)."""

    def __init__(self, data, srgb_gamma: bool = False):
        self.data = _numpy(data)
        self.srgb_gamma = srgb_gamma

    @property
    def width(self):
        return self.data.shape[1]

    @property
    def height(self):
        return self.data.shape[0]

    def convert(self, srgb_gamma: bool = False):
        d = self.data
        if self.srgb_gamma and not srgb_gamma:
            d = srgb_to_linear(d)
        elif srgb_gamma and not self.srgb_gamma:
            d = linear_to_srgb(np.clip(d, 0, 1))
        return Bitmap(d, srgb_gamma)

    def write(self, path: str):
        write_image(path, self.data, self.srgb_gamma)


def read_image(path: str) -> Bitmap:
    ext = os.path.splitext(path)[1].lower()
    if ext in (".png", ".jpg", ".jpeg", ".bmp", ".tga", ".ppm"):
        from PIL import Image
        img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
        return Bitmap(srgb_to_linear(img), srgb_gamma=False)
    if ext == ".pfm":
        return Bitmap(_read_pfm(path))
    if ext == ".hdr":
        return Bitmap(_read_rgbe(path))
    if ext == ".exr":
        return Bitmap(_read_exr(path))
    if ext == ".npy":
        return Bitmap(np.load(path).astype(np.float32))
    raise ValueError(f"unsupported image format {ext}")


def write_image(path: str, data, srgb_encoded: bool = False):
    data = _numpy(data)
    ext = os.path.splitext(path)[1].lower()
    if ext in (".png", ".jpg", ".jpeg"):
        from PIL import Image
        d = data if srgb_encoded else linear_to_srgb(np.clip(data, 0, 1))
        Image.fromarray((np.clip(d, 0, 1) * 255 + 0.5).astype(np.uint8)
                        ).save(path)
    elif ext == ".pfm":
        _write_pfm(path, data)
    elif ext == ".exr":
        _write_exr(path, data)
    elif ext == ".npy":
        np.save(path, data)
    else:
        raise ValueError(f"unsupported image format {ext}")


# ---------------------------------------------------------------------------
# PFM
# ---------------------------------------------------------------------------

def _read_pfm(path):
    with open(path, "rb") as f:
        header = f.readline().strip()
        color = header == b"PF"
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(
            f.read(), "<f4" if scale < 0 else ">f4",
            count=w * h * (3 if color else 1))
        data = data.reshape(h, w, 3 if color else 1)
        return np.flipud(data).astype(np.float32)


def _write_pfm(path, data):
    if data.ndim == 2:
        data = data[..., None]
    color = data.shape[2] >= 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(b"-1.0\n")
        out = np.flipud(data[..., :3] if color else data[..., :1])
        f.write(out.astype("<f4").tobytes())


# ---------------------------------------------------------------------------
# Radiance RGBE (.hdr)
# ---------------------------------------------------------------------------

def _read_rgbe(path):
    with open(path, "rb") as f:
        if not f.readline().startswith(b"#?"):
            raise ValueError("not an RGBE file")
        while True:
            line = f.readline().strip()
            if not line:
                break
        dims = f.readline().split()
        h, w = int(dims[1]), int(dims[3])
        raw = np.zeros((h, w, 4), np.uint8)
        for y in range(h):
            head = f.read(4)
            if head[:2] == b"\x02\x02":  # run-length encoded scanline
                row = np.zeros((w, 4), np.uint8)
                for c in range(4):
                    x = 0
                    while x < w:
                        count = f.read(1)[0]
                        if count > 128:
                            row[x:x + count - 128, c] = f.read(1)[0]
                            x += count - 128
                        else:
                            row[x:x + count, c] = np.frombuffer(
                                f.read(count), np.uint8)
                            x += count
                raw[y] = row
            else:  # flat
                rest = np.frombuffer(head + f.read(w * 4 - 4), np.uint8)
                raw[y] = rest.reshape(w, 4)
    e = raw[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)
    return (raw[..., :3].astype(np.float32) * scale[..., None]).astype(
        np.float32)


# ---------------------------------------------------------------------------
# OpenEXR (scanline, NO_COMPRESSION, ZIPS or ZIP, float/half, RGB(A))
# ---------------------------------------------------------------------------

_EXR_MAGIC = 20000630
_PT_HALF, _PT_FLOAT = 1, 2


def _write_exr(path, data):
    """Single-part scanline EXR, float32, ZIP-compressed blocks of 16
    rows (a block stays raw where zlib would not shrink it)."""
    if data.ndim == 2:
        data = data[..., None]
    h, w, c = data.shape
    names = ["R", "G", "B", "A"][:c] if c <= 4 else [
        f"channel{i}" for i in range(c)]
    order = np.argsort(names)  # EXR requires alphabetically sorted channels

    def attr(name, type_, payload):
        return (name.encode() + b"\x00" + type_.encode() + b"\x00"
                + struct.pack("<I", len(payload)) + payload)

    chlist = b""
    for i in order:
        chlist += (names[i].encode() + b"\x00"
                   + struct.pack("<iiii", _PT_FLOAT, 0, 1, 1))
    chlist += b"\x00"

    header = b""
    header += attr("channels", "chlist", chlist)
    header += attr("compression", "compression", b"\x03")  # ZIP
    header += attr("dataWindow", "box2i",
                   struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += attr("displayWindow", "box2i",
                   struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += attr("lineOrder", "lineOrder", b"\x00")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    # ZIP compresses blocks of 16 rows after EXR's predictor and byte
    # reordering
    blocks = []
    for y0 in range(0, h, 16):
        rows = []
        for y in range(y0, min(y0 + 16, h)):
            for i in order:
                rows.append(data[y, :, i].astype("<f4").tobytes())
        rawb = b"".join(rows)
        comp = zlib.compress(_exr_predictor_encode(rawb), 6)
        if len(comp) >= len(rawb):
            comp = rawb
        blocks.append((y0, comp))

    with open(path, "wb") as f:
        f.write(struct.pack("<I", _EXR_MAGIC))
        f.write(struct.pack("<I", 2))  # version 2, single-part scanline
        f.write(header)
        offset_table_pos = f.tell()
        f.write(b"\x00" * 8 * len(blocks))
        offsets = []
        for y0, comp in blocks:
            offsets.append(f.tell())
            f.write(struct.pack("<i", y0))
            f.write(struct.pack("<I", len(comp)))
            f.write(comp)
        f.seek(offset_table_pos)
        for off in offsets:
            f.write(struct.pack("<Q", off))


def _exr_predictor_encode(data: bytes) -> bytes:
    arr = np.frombuffer(data, np.uint8).astype(np.int16)
    d = np.empty_like(arr)
    d[0] = arr[0]
    d[1:] = (arr[1:] - arr[:-1] + 128 + 256) % 256
    d = d.astype(np.uint8)
    half = (len(d) + 1) // 2
    out = np.empty_like(d)
    out[:half] = d[0::2]
    out[half:] = d[1::2]
    return out.tobytes()


def _exr_predictor_decode(data: bytes) -> bytes:
    arr = np.frombuffer(data, np.uint8).copy()
    half = (len(arr) + 1) // 2
    interleaved = np.empty_like(arr)
    interleaved[0::2] = arr[:half]
    interleaved[1::2] = arr[half:]
    # predictor: d[i] = d[i-1] + raw[i] - 128 (mod 256)
    raw = interleaved.astype(np.int64)
    dec = np.cumsum(np.concatenate([raw[:1], raw[1:] - 128])) % 256
    return dec.astype(np.uint8).tobytes()


def _read_exr(path):
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<II", buf, 0)
    if magic != _EXR_MAGIC:
        raise ValueError("not an EXR file")
    pos = 8
    channels = []
    compression = 0
    dw = None
    while True:
        end = buf.index(b"\x00", pos)
        name = buf[pos:end].decode()
        pos = end + 1
        if name == "":
            break
        end = buf.index(b"\x00", pos)
        pos = end + 1                       # the attribute's type name
        (size,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        payload = buf[pos:pos + size]
        pos += size
        if name == "channels":
            p = 0
            while payload[p] != 0:
                e = payload.index(b"\x00", p)
                cname = payload[p:e].decode()
                ptype = struct.unpack_from("<i", payload, e + 1)[0]
                channels.append((cname, ptype))
                p = e + 1 + 16
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            dw = struct.unpack("<iiii", payload)
    if compression not in (0, 2, 3):
        raise ValueError(f"unsupported EXR compression {compression}")
    w = dw[2] - dw[0] + 1
    h = dw[3] - dw[1] + 1
    rows_per_block = 16 if compression == 3 else 1
    n_blocks = -(-h // rows_per_block)
    offsets = struct.unpack_from(f"<{n_blocks}Q", buf, pos)
    dt = {1: np.float16, 2: np.float32, 0: np.uint32}
    out = {c: np.zeros((h, w), np.float32) for c, _ in channels}
    for off in offsets:
        y0, size = struct.unpack_from("<iI", buf, off)
        y0 -= dw[1]
        comp = buf[off + 8: off + 8 + size]
        nrows = min(rows_per_block, h - y0)
        raw_size = sum(w * nrows * np.dtype(dt[t]).itemsize
                       for _, t in channels)
        if compression and size < raw_size:
            raw = _exr_predictor_decode(zlib.decompress(comp))
        else:
            raw = comp
        p = 0
        for y in range(y0, y0 + nrows):
            for cname, ptype in channels:     # alphabetical in the file
                nbytes = w * np.dtype(dt[ptype]).itemsize
                out[cname][y] = np.frombuffer(
                    raw[p:p + nbytes], dt[ptype]).astype(np.float32)
                p += nbytes
    names = [c for c, _ in channels]
    if set("RGB").issubset(names):
        img = np.stack([out["R"], out["G"], out["B"]], -1)
    else:
        img = np.stack([out[c] for c in names], -1)
    return img.astype(np.float32)
