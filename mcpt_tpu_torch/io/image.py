"""PNG output matching the reference's tonemap and save pipeline, and the
PNG and Radiance HDR loaders (textures and inverse-rendering targets).

Reference: src/Scene.cpp:23-53 — mean over spp, clamp [0,1], gamma 1/2,
x255.99 to u8, vertical flip, PNG. Copied from mcpt_tpu/io/image.py.
"""
from __future__ import annotations

import os

import numpy as np


def tonemap(accum: np.ndarray, spp) -> np.ndarray:
    """accum f32[H,W,3], spp broadcastable -> u8[H,W,3]."""
    rgb = np.asarray(accum, np.float32) / np.maximum(np.asarray(spp, np.float32), 1e-30)
    rgb = np.clip(rgb, 0.0, 1.0) ** 0.5  # gamma 1/2 (Scene.cpp:26-29)
    return (rgb * 255.99).astype(np.uint8)


def save_png(path: str, accum: np.ndarray, spp, flip: bool = True) -> str:
    from PIL import Image

    img = tonemap(accum, spp)
    if flip:
        img = img[::-1]  # vertical flip (Scene.cpp:40-45)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(img).save(path)
    return path


def load_png(path: str) -> np.ndarray:
    """Load a PNG to float [0,1], top row first (no flip)."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def load_hdr(path: str) -> np.ndarray:
    """Minimal Radiance RGBE (.hdr) decoder -> linear f32[H,W,3].

    The reference's HDR texture path (src/model.cpp:8-23, stbi_loadf):
    components decode as c * 2^(e-136), from new-style RLE scanlines or
    flat RGBE. Copied from mcpt_tpu/io/image.py; runs once at scene load.
    """
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"#?"):
            raise ValueError(f"{path}: not a Radiance RGBE file")
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n"):
                break
            if line == b"":
                raise ValueError(f"{path}: truncated header")
        dims = f.readline().split()
        if len(dims) != 4 or dims[0] != b"-Y" or dims[2] != b"+X":
            raise ValueError(f"{path}: unsupported resolution line {dims!r}")
        H, W = int(dims[1]), int(dims[3])
        data = np.frombuffer(f.read(), np.uint8)

    img = np.zeros((H, W, 4), np.uint8)
    pos = 0
    for y in range(H):
        if (
            8 <= W < 32768
            and pos + 4 <= len(data)
            and data[pos] == 2
            and data[pos + 1] == 2
            and ((int(data[pos + 2]) << 8) | int(data[pos + 3])) == W
        ):
            pos += 4  # new-style RLE: 4 per-component runs
            for ch in range(4):
                x = 0
                while x < W:
                    n = int(data[pos]); pos += 1
                    if n > 128:  # run of one repeated byte
                        img[y, x : x + n - 128, ch] = data[pos]
                        pos += 1
                        x += n - 128
                    else:  # literal run
                        img[y, x : x + n, ch] = data[pos : pos + n]
                        pos += n
                        x += n
        else:  # flat RGBE scanline
            img[y] = data[pos : pos + 4 * W].reshape(W, 4)
            pos += 4 * W

    e = img[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(np.float32(1.0), e - 136), 0.0).astype(np.float32)
    return img[..., :3].astype(np.float32) * scale[..., None]
