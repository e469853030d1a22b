"""Image export/import: PNG and Radiance HDR natively, JPG/BMP/TGA via Pillow.

Replaces the stb_image_write-based export path of the reference
(/root/reference/satellite/src/Visualization.cpp:286-357 and the vendored
stb_image_write.h): LDR export clamps to [0,1] with an overflow warning,
HDR export writes float radiance. PNG (8-bit, non-interlaced) is written
and read with numpy and zlib, so the main path needs no imaging package;
Pillow is imported only for the other LDR formats.
"""
from __future__ import annotations

import logging
import os
import struct
import zlib

import numpy as np

__all__ = ["save_image", "save_hdr", "load_image", "load_hdr", "srgb_decode",
           "save_png", "load_png"]

log = logging.getLogger("terra_tpu")


def srgb_decode(img: np.ndarray) -> np.ndarray:
    """Gamma 2.2 decode at load time (terra_texture_finalize,
    Terra.c:484-507)."""
    return np.power(np.clip(img, 0.0, 1.0), 2.2).astype(np.float32)


def save_image(path: str, img) -> None:
    """Save a float image to PNG/JPG/BMP/TGA (clamped to [0,1], 8-bit) or
    .hdr — the same format set as the reference's vendored stb_image_write
    (satellite/src/stb_image_write.h).

    Emits the reference's overflow warning when values exceed 1
    (Visualization.cpp:334-341).
    """
    img = np.asarray(img, np.float32)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        save_hdr(path, img)
        return
    if (img > 1.0 + 1e-6).any():
        log.warning("image contains values > 1; clamping on LDR export (%s)", path)
    u8 = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if ext == ".png":
        save_png(path, u8)
        return
    _pillow(ext).fromarray(u8).save(path)


def _pillow(ext: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{ext} images need Pillow (PIL), which is not "
                          "installed; PNG and HDR need nothing") from e
    return Image


_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type -> samples per pixel


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_png(path: str, u8: np.ndarray) -> None:
    """Write an (H, W), (H, W, 1|2|3|4) uint8 array as an 8-bit,
    non-interlaced PNG (filter type 0 on every row)."""
    u8 = np.asarray(u8, np.uint8)
    if u8.ndim == 2:
        u8 = u8[..., None]
    h, w, c = u8.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), u8.reshape(h, w * c)], axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth)."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind = raw[y, 0]
        line = raw[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 2:
            cur = (line + prev) & 0xFF
        else:  # Sub / Average / Paeth depend on the reconstructed left pixel
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + prev[x]) >> 1
                elif kind == 4:
                    b, cc = prev[x], prev[x - bpp] if x >= bpp else 0
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
                else:
                    raise ValueError(f"bad PNG filter type {kind}")
                cur[x] = (line[x] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out


def load_png(path: str) -> np.ndarray:
    """Read an 8-bit, non-interlaced PNG (gray, gray+alpha, RGB, RGBA) to
    an (H, W, C) uint8 array."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or interlace != 0 or color not in _PNG_CHANNELS:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray/RGB(A) PNGs "
                         f"are supported (depth {depth}, color type {color}, "
                         f"interlace {interlace})")
    c = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:h * (w * c + 1)].reshape(h, w * c + 1)
    return _unfilter(raw, h, w * c, c).reshape(h, w, c)


def save_hdr(path: str, img: np.ndarray) -> None:
    """Minimal Radiance RGBE (.hdr) writer (flat, non-RLE scanlines)."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    maxc = img.max(axis=-1)
    valid = maxc > 1e-32
    exp = np.zeros((h, w), np.int32)
    mant = np.zeros((h, w), np.float32)
    m, e = np.frexp(np.maximum(maxc, 1e-32))
    exp = np.where(valid, e, 0)
    scale = np.where(valid, m * 256.0 / np.maximum(maxc, 1e-32), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(valid, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def load_hdr(path: str) -> np.ndarray:
    """Minimal Radiance RGBE (.hdr) reader (flat and RLE scanlines)."""
    with open(path, "rb") as f:
        data = f.read()
    # header ends at the first blank line; next line is the resolution
    head_end = data.find(b"\n\n")
    if head_end < 0:
        raise ValueError("not a Radiance file")
    rest = data[head_end + 2:]
    nl = rest.find(b"\n")
    dims = rest[:nl].split()
    if dims[0] != b"-Y" or dims[2] != b"+X":
        raise ValueError(f"unsupported orientation {dims!r}")
    h, w = int(dims[1]), int(dims[3])
    payload = rest[nl + 1:]
    rgbe = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        if w >= 8 and len(payload) - pos >= 4 and payload[pos] == 2 and payload[pos + 1] == 2:
            # adaptive RLE scanline
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = payload[pos]
                    pos += 1
                    if count > 128:  # run
                        rgbe[y, x : x + count - 128, c] = payload[pos]
                        pos += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x : x + count, c] = np.frombuffer(
                            payload, np.uint8, count, pos
                        )
                        pos += count
                        x += count
        else:
            row = np.frombuffer(payload, np.uint8, w * 4, pos).reshape(w, 4)
            rgbe[y] = row
            pos += w * 4
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp > 0, np.ldexp(1.0, exp - 136), 0.0).astype(np.float32)
    return (rgbe[..., :3].astype(np.float32) * scale[..., None]).astype(np.float32)


def load_image(path: str, srgb: bool = True) -> np.ndarray:
    """Load an LDR/HDR image to float32 (H, W, 3); LDR optionally
    sRGB-decoded like the reference's finalize pass."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        return load_hdr(path)
    if ext == ".png":
        u8 = load_png(path)
        if u8.shape[2] < 3:  # gray (+ alpha) -> RGB
            u8 = np.repeat(u8[..., :1], 3, axis=2)
        arr = u8[..., :3].astype(np.float32) / 255.0
    else:
        with _pillow(ext).open(path) as im:
            arr = np.asarray(im.convert("RGB"), np.float32) / 255.0
    return srgb_decode(arr) if srgb else arr
