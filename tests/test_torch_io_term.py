"""The port's image loaders, texture atlas and terminal preview against
mcpt_tpu's on the CPU: load_png and load_hdr (flat and RLE Radiance
files, written as tests/test_io.py writes them) bitwise, an atlas with an
.hdr and a .png texture bitwise, and ansi_frame string-equal."""
import os
import shutil

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_hdr_pair(dirp, seed):
    """A flat and an RLE Radiance file of the same 4x16 image (the RLE one
    encodes each scanline's components as a literal run and a repeated run,
    as tests/test_io.py does)."""
    H, W = 4, 16
    rng = np.random.default_rng(seed)
    rgbe = rng.integers(1, 255, (H, W, 4), dtype=np.uint8)
    rgbe[..., 3] = rng.integers(120, 140, (H, W))
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {H} +X {W}\n".encode()
    flat = os.path.join(dirp, "flat.hdr")
    with open(flat, "wb") as f:
        f.write(header + rgbe.tobytes())
    out = bytearray(header)
    half = W // 2
    for y in range(H):
        out += bytes([2, 2, W >> 8, W & 0xFF])
        for ch in range(4):
            row = rgbe[y, :, ch]
            out += bytes([half]) + row[:half].tobytes() + bytes([128 + half, int(row[half])])
    rle = os.path.join(dirp, "rle.hdr")
    with open(rle, "wb") as f:
        f.write(bytes(out))
    return flat, rle


def test_load_hdr_and_png_equal_jax_bitwise(tmp_path):
    from PIL import Image

    from mcpt_tpu.io import image as J
    from mcpt_tpu_torch.io import image as T

    for seed in (0, 1):
        for path in _write_hdr_pair(str(tmp_path), seed):
            a, b = T.load_hdr(path), J.load_hdr(path)
            assert a.dtype == b.dtype == np.float32 and a.shape == (4, 16, 3)
            np.testing.assert_array_equal(a, b)
            assert (a > 0).all()
    img = np.random.default_rng(2).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    png = str(tmp_path / "t.png")
    Image.fromarray(img).save(png)
    a, b = T.load_png(png), J.load_png(png)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, img.astype(np.float32) / 255.0)


def _textured_cornell(dirp):
    """cornell-box with an .hdr texture on 'white' and a .png on 'red'."""
    from PIL import Image

    for ext in ("obj", "xml"):
        shutil.copy(os.path.join(ROOT, "scenes", f"cornell-box.{ext}"), dirp)
    mtl = open(os.path.join(ROOT, "scenes", "cornell-box.mtl")).read()
    mtl = mtl.replace("Kd 0.725 0.71 0.68", "Kd 0.725 0.71 0.68\nmap_Kd tex.hdr")
    mtl = mtl.replace("Kd 0.63 0.065 0.05", "Kd 0.63 0.065 0.05\nmap_Kd tex.png")
    with open(os.path.join(dirp, "cornell-box.mtl"), "w") as f:
        f.write(mtl)
    flat, _ = _write_hdr_pair(dirp, 3)
    os.replace(flat, os.path.join(dirp, "tex.hdr"))
    img = np.random.default_rng(4).integers(0, 256, (6, 9, 3), dtype=np.uint8)
    Image.fromarray(img).save(os.path.join(dirp, "tex.png"))
    return os.path.join(dirp, "cornell-box.obj")


def test_hdr_texture_atlas_equals_jax_and_renders(tmp_path):
    """The atlas of a scene with an .hdr (linear) and a .png (gamma 2.2)
    texture equals mcpt_tpu.io.obj.load_scene's bit for bit, and the scene
    renders with the textures on (16x16, 1 spp, 2 bounces)."""
    from mcpt_tpu.io.obj import load_scene as jax_load
    from mcpt_tpu_torch.io.obj import load_scene
    from mcpt_tpu_torch.render.renderer import RenderConfig, Renderer

    path = _textured_cornell(str(tmp_path))
    s = load_scene(path, device="cpu")
    j = jax_load(path, with_bvh=True)
    np.testing.assert_array_equal(s.atlas.data.numpy(), np.asarray(j.atlas.data))
    np.testing.assert_array_equal(s.atlas.size.numpy(), np.asarray(j.atlas.size))
    np.testing.assert_array_equal(s.mats.tex_id.numpy(), np.asarray(j.mats.tex_id))
    assert s.atlas.data.shape[0] == 2 and float(s.atlas.data.max()) > 1.0  # HDR stays linear
    r = Renderer(s, RenderConfig(max_bounces=2, width=16, height=16))
    r.step()
    assert r.stats["nan_scrubbed"] == 0 and float(r.film.accum.mean()) > 0


def test_ansi_frame_equals_jax():
    """Same film -> the same ANSI string, downsampled or not; the port's
    film holds a tensor and Python counters, mcpt_tpu's arrays."""
    from mcpt_tpu.io import term as J
    from mcpt_tpu.render.film import Film as JFilm
    from mcpt_tpu_torch.io import term as T
    from mcpt_tpu_torch.render.film import Film

    rng = np.random.default_rng(5)
    for H, W, cols, rows in ((8, 8, 8, 4), (48, 64, 20, 7), (33, 17, 96, 28)):
        accum = rng.uniform(0, 3, (H, W, 3)).astype(np.float32)
        jf = JFilm(accum=accum, spp=np.float32(2.0), nan_count=np.zeros((), np.int32), rays=np.zeros(()))
        tf = Film(accum=torch.from_numpy(accum), spp=2.0, nan_count=0, rays=0.0)
        assert T.ansi_frame(tf, max_cols=cols, max_rows=rows) == J.ansi_frame(jf, max_cols=cols, max_rows=rows)
        np.testing.assert_array_equal(T.tonemap_u8(tf.accum, tf.spp), J.tonemap_u8(accum, np.float32(2.0)))
