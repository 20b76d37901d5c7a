#!/usr/bin/env python3
"""Drive the mcpt_tpu_torch port once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing its wall seconds:
  1. the device, and the card's name and power limit from nvidia-smi;
  2. one nvcc build of every kernel under mcpt_tpu_torch/csrc;
  3. each kernel against its plain torch version on the card, on veach-mis
     rays at the main path's shapes, with times (CUDA events);
  4. the main path: Renderer on veach-mis at 1024x1024, 24 bounces, two
     passes of 1 spp, counting kernel launches.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Any failure raises and exits
nonzero; without a CUDA card the script exits 1 before printing a result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
VEACH = os.path.join(ROOT, "scenes", "veach-mis.obj")
WIDTH = HEIGHT = 1024
MAX_BOUNCES = 24
PASSES = 2
N_RANDOM = 1 << 18  # random rays added to the 1024^2 primary rays
# Share of rays whose kernel and plain results must agree. The kernels are
# built to equal their plain versions bit for bit, so a single differing ray
# fails the check too.
AGREE_MIN = 0.999
RTOL = 1e-5  # t, u, v where the closest-hit ids agree
H100_FP32_OPS = 67e12  # FP32 peak outside the tensor cores, dense (SXM data sheet)
H100_BYTES = 3.35e12  # HBM3 bytes per second
CLOSEST_OPS = 41  # f32 operations per (ray, triangle) test, csrc/woop.cu
ANY_OPS = 40


def phase(name):
    def wrap(fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            print(f"[phase] {name}: {time.perf_counter() - t0:.2f} s", flush=True)
            return out
        return run
    return wrap


def cuda_time_ms(fn, reps=7):
    """Median ms of `reps` runs after one warm-up, timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


@phase("1 device")
def device_info():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda}")
    print(f"nvidia-smi: {card}")
    return card


@phase("2 build")
def build_kernels():
    from mcpt_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    print(f"built {os.path.relpath(path, ROOT)} in {time.perf_counter() - t0:.2f} s")
    info = _build.last_build
    if info:
        print(f"nvcc: {info['cmd']}\n{info['output'].strip()}")


def _pairs(ws, rays, mask, first_hit_ends):
    """(ray, real triangle) tests this input needs: tested rays against the
    real triangles of their tiles' live chunks; with `first_hit_ends` a ray
    stops at its first accept (any-hit)."""
    import torch

    from mcpt_tpu_torch.ops import woop

    ids = torch.nonzero(woop._active(rays))[:, 0]
    total = 0
    for r0 in range(0, ids.shape[0], 1 << 15):
        sel = ids[r0:r0 + (1 << 15)]
        ry = rays[sel]
        word = mask[sel // woop.RAY_TILE].to(torch.int64)
        done = torch.zeros(sel.shape[0], dtype=torch.bool, device=rays.device)
        for c in range(ws.n_chunks):
            live = ((word >> c) & 1) != 0
            real = max(0, min(ws.chunk, ws.n_tris - c * ws.chunk))
            if not first_hit_ends:
                total += int(live.sum()) * real
                continue
            t, u, v, ok = woop._project(ry, ws.tbl, ws.eps_any, c, ws.chunk)
            acc = (ok & (u >= 0) & (u <= 1.0) & (v >= 0) & (u + v <= 1.0)
                   & (t >= ry[:, 3:4]) & (t <= ry[:, 7:8]))[:, :real]
            run = live & ~done
            has = acc.any(dim=1)
            first = torch.where(has, acc.int().argmax(dim=1) + 1, real)
            total += int(torch.where(run, first, 0).sum())
            done |= run & has
    return total


@phase("3 kernels vs plain")
def check_kernels(scene):
    import torch

    from mcpt_tpu_torch.ops import woop
    from mcpt_tpu_torch.render.camera import generate_rays
    from mcpt_tpu_torch.render.integrator import RAY_EPS_REL

    dev = scene.device
    ws = scene.woop
    g = torch.Generator(device=dev).manual_seed(0)
    cam = scene.camera
    pix = torch.arange(WIDTH * HEIGHT, device=dev)
    o_cam, d_cam = generate_rays(cam, torch.rand((pix.shape[0], 2), generator=g, device=dev), pix)
    lo = scene.geom.v0.amin(0)
    hi = scene.geom.v0.amax(0)
    o_rnd = lo + (hi - lo) * torch.rand((N_RANDOM, 3), generator=g, device=dev)
    d_rnd = torch.nn.functional.normalize(torch.randn((N_RANDOM, 3), generator=g, device=dev), dim=1)
    t_min = RAY_EPS_REL * scene.scale
    F = woop.F32_MAX

    # closest hit: camera rays (the main path's first trace) + random rays
    o = torch.cat([o_cam, o_rnd]).contiguous()
    d = torch.cat([d_cam, d_rnd]).contiguous()
    rays_c = woop.pack_rays(o, d, t_min, F)
    mask_c = woop.tile_chunk_mask(rays_c, ws.boxes)
    k = woop.closest_hit_woop_kernel(ws, rays_c, mask_c)
    torch.cuda.synchronize()
    p = woop.closest_hit_woop_plain(ws, rays_c, mask_c)
    same = k[1] == p[1]
    n_diff = int((~same).sum())
    agree = float(same.float().mean())
    both = same & (p[1] >= 0)
    err = max(float((k[i][both] - p[i][both]).abs().max()) if both.any() else 0.0 for i in (0, 2, 3))
    close = all(torch.allclose(k[i][both], p[i][both], rtol=RTOL, atol=0.0) for i in (0, 2, 3))
    bitwise = all(torch.equal(k[i][both], p[i][both]) for i in (0, 2, 3))
    print(f"closest: {rays_c.shape[0]} rays, hits {float((p[1] >= 0).float().mean()):.4f}, "
          f"tri agree {agree:.6f} ({n_diff} rays differ), bitwise t/u/v {bitwise}, max abs err {err:.3g}")
    if agree < AGREE_MIN or not close:
        raise AssertionError(f"closest-hit kernel disagrees with its plain version: agree {agree}, close {close}")
    if n_diff or not bitwise:  # both sides round every operation alike (ops/woop.py)
        raise AssertionError(f"closest-hit kernel is not bitwise equal to its plain version: "
                             f"{n_diff} ids differ, bitwise t/u/v {bitwise}")

    # any hit: shadow rays from the camera rays' hits to random scene points
    # (finite t_max) + random rays with random finite t_max
    hit = p[1][: o_cam.shape[0]] >= 0
    so = (o_cam + d_cam * p[0][: o_cam.shape[0], None])[hit]
    target = lo + (hi - lo) * torch.rand(so.shape, generator=g, device=dev)
    sv = target - so
    dist = sv.norm(dim=1)
    sd = sv / dist[:, None]
    o_a = torch.cat([so, o_rnd]).contiguous()
    d_a = torch.cat([sd, d_rnd]).contiguous()
    tmax = torch.cat([dist * (1 - 1e-3),
                      scene.scale * torch.rand(N_RANDOM, generator=g, device=dev)])
    rays_a = woop.pack_rays(o_a, d_a, t_min, tmax)
    mask_a = woop.tile_chunk_mask(rays_a, ws.boxes)
    ka = woop.any_hit_woop_kernel(ws, rays_a, mask_a)
    torch.cuda.synchronize()
    pa = woop.any_hit_woop_plain(ws, rays_a, mask_a)
    n_diff_a = int((ka != pa).sum())
    agree_a = float((ka == pa).float().mean())
    err_a = float((ka.int() - pa.int()).abs().max())
    print(f"any: {rays_a.shape[0]} rays, occluded {float(pa.float().mean()):.4f}, agree {agree_a:.6f} "
          f"({n_diff_a} rays differ)")
    if agree_a < AGREE_MIN or n_diff_a:
        raise AssertionError(f"any-hit kernel disagrees with its plain version on {n_diff_a} rays")

    # times at the main path's shapes: the 1024^2 camera rays, and shadow rays
    n_cam = o_cam.shape[0]
    rc, mc = rays_c[:n_cam].contiguous(), mask_c[: n_cam // woop.RAY_TILE].contiguous()
    ra = rays_a[: so.shape[0]].contiguous()
    ma = woop.tile_chunk_mask(ra, ws.boxes)
    out = []
    for name, kern, plain, ry, m, ops, first_end, replaces, in_bytes, out_bytes in (
        ("woop_closest", woop.closest_hit_woop_kernel, woop.closest_hit_woop_plain, rc, mc,
         CLOSEST_OPS, False, "mcpt_tpu/ops/pallas/woop.py:183", 32, 16),
        ("woop_any", woop.any_hit_woop_kernel, woop.any_hit_woop_plain, ra, ma,
         ANY_OPS, True, "mcpt_tpu/ops/pallas/woop.py:255", 32, 1),
    ):
        ms = cuda_time_ms(lambda: kern(ws, ry, m))
        plain_ms = cuda_time_ms(lambda: plain(ws, ry, m), reps=5)
        pairs = _pairs(ws, ry, m, first_end)
        nbytes = ry.shape[0] * (in_bytes + out_bytes) + 4 * (ws.tbl.numel() + ws.eps_any.numel() + m.numel())
        ops_s = pairs * ops / H100_FP32_OPS
        bytes_s = nbytes / H100_BYTES
        bound_ms = 1e3 * max(ops_s, bytes_s)
        print(f"{name}: {ry.shape[0]} rays, {pairs} live pairs, kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms ({'operations' if ops_s >= bytes_s else 'bytes'})")
        out.append({"name": name, "route": "cuda", "source": "mcpt_tpu_torch/csrc/woop.cu",
                    "replaces": replaces, "launches": 0,
                    "max_abs_err": err if name == "woop_closest" else err_a,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": "operations" if ops_s >= bytes_s else "bytes",
                    "library_ms": None})
    return out


@phase("4 main path")
def main_path(scene):
    import numpy as np
    import torch

    from mcpt_tpu_torch.ops import woop
    from mcpt_tpu_torch.render.renderer import RenderConfig, Renderer

    r = Renderer(scene, RenderConfig(max_bounces=MAX_BOUNCES, width=WIDTH, height=HEIGHT,
                                     spp_per_pass=1, seed=0))
    for counts in (woop.LAUNCHES, woop.PLAIN_CALLS):
        for k in counts:
            counts[k] = 0
    for i in range(PASSES):
        r.step()
        print(f"pass {i}: {r.pass_times[-1]:.3f} s")
    launches, plain = dict(woop.LAUNCHES), dict(woop.PLAIN_CALLS)
    st = r.stats
    img = r.film.accum / r.film.spp
    mean = [float(x) for x in img.mean(dim=(0, 1))]
    print(f"launches {launches}, plain calls {plain}, traced rays {st['traced_rays']:.0f}, "
          f"{st['mrays_per_s']:.2f} Mrays/s, nan_scrubbed {st['nan_scrubbed']}, mean RGB {mean}")
    if min(launches.values()) == 0 or max(plain.values()) != 0:
        raise AssertionError(f"main path did not run through the kernels: {launches}, plain {plain}")
    if st["nan_scrubbed"] != 0 or not all(np.isfinite(mean)) or min(mean) <= 0:
        raise AssertionError(f"bad film: nan_scrubbed {st['nan_scrubbed']}, mean {mean}")
    with tempfile.TemporaryDirectory() as tmp:
        path = r.save(os.path.join(tmp, "veach.png"))
        print(f"saved a {os.path.getsize(path)}-byte PNG")
    return launches


@phase("5 small render, card vs CPU")
def small_reference(scene_cuda):
    """The same small render through the kernels and through the plain
    versions on the CPU: means within rtol 2e-3, >= 99 % of components
    within 1e-3 (tests/test_woop.py's render contract)."""
    import numpy as np

    from mcpt_tpu_torch.io.obj import load_scene
    from mcpt_tpu_torch.render.renderer import RenderConfig, Renderer

    imgs = []
    for scene in (scene_cuda, load_scene(VEACH, device="cpu")):
        r = Renderer(scene, RenderConfig(max_bounces=8, width=64, height=48, spp_per_pass=2, seed=1))
        r.step()
        imgs.append((r.film.accum / r.film.spp).cpu().numpy())
    a, b = imgs
    close = float(np.isclose(a, b, rtol=1e-3, atol=1e-3).mean())
    ma, mb = a.mean(axis=(0, 1)), b.mean(axis=(0, 1))
    print(f"64x48x2spp: components close {close:.5f}, mean card {ma}, mean cpu {mb}")
    if close < 0.99 or not np.allclose(ma, mb, rtol=2e-3, atol=0.0):
        raise AssertionError("card render disagrees with the CPU render")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    card = device_info()
    build_kernels()

    from mcpt_tpu_torch.io.obj import load_scene

    t0 = time.perf_counter()
    scene = load_scene(VEACH, device="cuda")
    print(f"[phase] load veach-mis ({scene.num_tris} triangles, {scene.woop.n_chunks} chunks "
          f"of {scene.woop.chunk}): {time.perf_counter() - t0:.2f} s")
    kernels = check_kernels(scene)
    launches = main_path(scene)
    for k in kernels:
        k["launches"] = launches[k["name"].split("_")[1]]
    small_reference(scene)
    print(f"total {time.perf_counter() - t_start:.2f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
