"""PNG output matching the reference's tonemap and save pipeline.

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
