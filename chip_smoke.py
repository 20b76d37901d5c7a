#!/usr/bin/env python3
"""Drive the mcpt_tpu_torch port once on one CUDA card and check it.

    python3 chip_smoke.py [--save-closest-batch PATH] [--save-batches DIR]

Phases, each printing its wall seconds:
  1. the device, and the card's name and power limit from nvidia-smi;
  2. one nvcc build of every kernel under mcpt_tpu_torch/csrc, and the g++
     build of the host BVH builder (csrc/host), with the -Xptxas -v lines
     of the Woop, traversal, schedule and select kernels;
  3. the Woop kernels against their plain torch versions on the card, on
     veach-mis rays at the main path's shapes, with times (CUDA events) and
     the share of pairs their interval pre-tests reject;
  4. the veach main path: Renderer on veach-mis at 1024x1024, 24 bounces,
     two passes of 1 spp, counting kernel launches; then the any-hit
     kernel against its plain version on the pass's first NEE shadow
     batch and the closest-hit kernel against its plain version on the
     pass's third closest-hit batch, both captured on the way, with times;
  5. a small veach render on the card against the same render on the CPU;
  6. bathroom-stress (999,698 triangles) generated in memory, as
     scenes/generate.py's gen_stress writes it, its BVH built and uploaded,
     its traversal tables (child-pair table included) packed again, timed;
  7. the BVH traversal kernels against their plain versions on the card,
     on its 1280x720 camera rays and their shadow rays, with times; each
     kernel's walk of the child-pair table against the skip-link walk;
  8. the bathroom main path: Renderer at 1280x720, 24 bounces, two passes
     of 1 spp, counting kernel launches; then both kernels against their
     plain versions and the skip-link walks on the pass's third closest-hit
     and third any-hit batches, captured on the way, with times;
  9. a small render of a 5,986-triangle stress scene on the card against
     the same render on the CPU;
 10. bathroom-stress's treelet layout built again from its BVH, timed;
 11. the schedule pre-pass kernel against its plain version, and the
     schedule walk kernels (per-ray walks of each scheduled treelet's staged
     sub-BVH) against their plain walks, the reference (packet) walk and,
     with the exact fallback, traverse.cu, on phase 7's camera and shadow
     rays and on a scrambled batch, with both walks' counts and times of the
     pre-pass, the kernel, the fallback and the whole entry point;
 12. the select kernels against their plain walks (per-ray walks of each
     staged treelet) on phase 7's batches, against the reference walk
     (every triangle of every treelet a tile visits) and traverse.cu, with
     both walks' counts, and against traverse.cu on phase 8's third
     batches, with times;
 13. the bathroom main path of phase 8 through the select kernels
     (MCPT_TREELET_SELECT=smem dispatch), its film against phase 8's;
 14. phase 9's render through the select kernels, card against CPU.
The line before the last is a JSON object with one entry per kernel (the
eight that replace TPU kernels, and the schedule pre-pass, which replaces
none); the last line is {"ok": true, "device": {...}}. Any failure raises
and exits nonzero; without a CUDA card the script exits 1 before printing a
result.

--save-closest-batch PATH saves the rays of phase 8's third closest-hit
batch to PATH; --save-batches DIR saves, for time_closest_batch.py, the
rays of the batches the Woop closest-hit and the traversal kernels are
timed on: woop_closest_camera.pt (phase 3), woop_closest_third.pt (phase
4), traverse_any_shadow.pt (phase 7, sorted), traverse_closest_third.pt
and traverse_any_third.pt (phase 8), the schedule kernels' tiles and rows
schedule_closest_camera.pt, schedule_any_shadow.pt,
schedule_closest_scrambled.pt, each with its *_rows.pt (phase 11), and the
select kernels' tiles select_closest_camera.pt, select_any_shadow.pt,
select_closest_third.pt and select_any_third.pt (phase 12).
"""
from __future__ import annotations

import functools
import json
import math
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
# Both Woop kernels (csrc/woop.cu) reject a pair by their interval test
# with 17 f32 operations: the projection's row 2 (11), |d'_z| >= eps, the
# sign of N, 2 products and 2 compares. Their bounds count those for a pair
# the pre-test rejects and CLOSEST_OPS or ANY_OPS for any other: the work
# this input needs. The bound at CLOSEST_OPS or ANY_OPS for every pair is
# printed beside it.
REJECT_OPS = 17
# bathroom-stress: the scene, its main path and the traversal kernels' check
STRESS_TRIS = 1_000_000  # gen_stress's target (999,698 triangles come out)
SMALL_STRESS_TRIS = 6000  # 5,986 triangles, still above the 4,096 of the Woop pair
BATH_W, BATH_H = 1280, 720
BATH_PASSES = 2
# f32 operations of csrc/traverse.cu: per node visit, the slab test (6 sub,
# 9 mul, 3 min + 3 max per axis, 2 max + 2 min across axes, max/min with
# the interval's ends, the compare) plus min(best_t, t_max) for closest hit;
# per triangle test, Moller-Trumbore (27 mul, 17 add/sub, abs, compare, one
# division) and the accept predicate (closest: 5 compares, 2 sub and
# min(best_t, t_max); any: 6 compares and an add).
TRAV_NODE_OPS = {"closest": 29, "any": 28}
TRAV_TRI_OPS = {"closest": 55, "any": 54}
SCHED_V = 512  # schedule capacity a tile (mcpt_tpu DEFAULT_V)
# Phase 11 holds the schedule walk kernels against the plain walks on every
# tile of the camera and shadow batches and on every 8th tile of the
# scrambled one (900 of 7,200): on an H100 the plain walk took 27 s for all.
SCRAMBLED_STRIDE = 8
# f32 operations of csrc/treelet.cu: per (ray, triangle) test, Moller-
# Trumbore (27 mul, 17 add/sub, abs, compare, one division) and the accept
# predicate (closest: 7 compares and 2 sub with the tie rule; any: 6
# compares and an add); per (ray, box) entry key, 2 sub, 2 mul, min, max,
# the 1.001 mul and the running max/min an axis, and max/min with the
# interval's ends, the compare and the clamp at 0.
TREELET_TRI_OPS = {"closest": 56, "any": 54}
TREELET_KEY_OPS = 31
# f32 operations of the schedule pre-pass a (tile, box) interval test: per
# axis, two planes of 2 sub, 4 mul, 3 min and 3 max, then min, max, the
# compare, the 1.001 mul, and the running max and min (30); across axes the
# ends' max and min, the compare (3).
PREPASS_BOX_OPS = 93
# Rays of a 921,600-ray batch, and pixels of a 1280x720 film, on which a
# treelet route or its reference (packet) walk may answer differently from
# the BVH walk: on a ray through two leaves' shared face a walk culls the
# second leaf when the face's slab entry computes to the running best_t,
# though the triangle there is one ulp closer; a walk that tests whole
# treelets keeps it (ROADMAP queue 3 item 4). Such rays are rare (0 or 1
# in each batch of phases 11-12, 1 pixel in phase 13's two passes), so
# more than this is a fault.
ROUTE_DIFF_MAX = 16


def phase(name):
    def wrap(fn):
        @functools.wraps(fn)
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
        for name in ("woop_closest_kernel", "woop_any_kernel", "traverse_closest_kernel",
                     "traverse_any_kernel", "schedule_prepass_kernel", "schedule_kernel", "select_kernel"):
            for line in _ptxas_usage(info["output"], name):
                print(f"ptxas {name}: {line}")
    t0 = time.perf_counter()
    path = _build.build_host()
    _build.host_library()
    print(f"built {os.path.relpath(path, ROOT)} in {time.perf_counter() - t0:.2f} s")
    info = _build.last_host_build
    if info:
        print(f"g++: {info['cmd']}\n{info['output'].strip()}")


def _ptxas_usage(output, name):
    """The -Xptxas -v lines (registers, shared memory, stack and spills) of
    every entry function whose mangled name holds `name`."""
    out, cur = [], None
    for line in output.splitlines():
        if "Compiling entry function" in line:
            cur = line.split("'")[1] if "'" in line else line
            continue
        if cur and name in cur and ("Used" in line or "stack frame" in line):
            out.append(f"{cur[cur.index(name):][:40]}: {line.replace('ptxas info    :', '').strip()}")
    return out


def _capture(mod, attr, which):
    """Wrap mod.attr so that its `which`-th call keeps its arguments in the
    returned dict (by reference: the wrappers make fresh tensors a call);
    the returned function restores the attribute."""
    orig = getattr(mod, attr)
    seen, store = [0], {}

    def wrapped(*args):
        seen[0] += 1
        if seen[0] == which:
            store["args"] = args
        return orig(*args)

    setattr(mod, attr, wrapped)
    return store, lambda: setattr(mod, attr, orig)


def _pairs(ws, rays, mask, first_hit_ends):
    """(ray, real triangle) tests this input needs: tested rays against the
    real triangles of their tiles' live chunks; with `first_hit_ends` a ray
    stops at its first accept (any-hit). Returns (pairs, operations,
    rejects): rejects are the pairs the kernel's interval pre-test rejects,
    replayed in the kernel's triangle order (ops/woop.py
    any_pretest_rejects; closest_pretest_rejects against each pair's running
    best_t); a pair counts REJECT_OPS where the pre-test rejects it and
    CLOSEST_OPS or ANY_OPS where it does not."""
    import torch

    from mcpt_tpu_torch.ops import woop

    ids = torch.nonzero(woop._active(rays))[:, 0]
    total = ops = rejects = 0
    cols = torch.arange(ws.n_chunks * ws.chunk, device=rays.device)
    for r0 in range(0, ids.shape[0], 1 << 15):
        sel = ids[r0:r0 + (1 << 15)]
        ry = rays[sel]
        word = mask[sel // woop.RAY_TILE].to(torch.int64)
        live = ((word[:, None] >> (cols // ws.chunk)[None, :]) & 1) != 0
        tested = live & (cols < ws.n_tris)[None, :]
        if not first_hit_ends:
            # the running best_t each pair meets: t_hi, then the least t accepted before it
            best = ry[:, 7].clone()
            before = []
            for c in range(ws.n_chunks):
                t, u, v, ok = woop._project(ry, ws.tbl, ws.eps_closest, c, ws.chunk)
                acc = (ok & (t >= ry[:, 3:4]) & (t < ry[:, 7:8]) & (u >= 0) & (v >= 0) & (1.0 - u - v >= 0)
                       & tested[:, c * ws.chunk:(c + 1) * ws.chunk])
                run = torch.cummin(torch.where(acc, t, float("inf")), dim=1).values
                b = torch.minimum(best[:, None], torch.cat([torch.full_like(run[:, :1], float("inf")),
                                                            run[:, :-1]], dim=1))
                before.append(b)
                best = torch.minimum(best, run[:, -1])
            rej = woop.closest_pretest_rejects(ws, ry, torch.cat(before, dim=1)) & tested
            n, n_rej = int(tested.sum()), int(rej.sum())
            total += n
            ops += n_rej * REJECT_OPS + (n - n_rej) * CLOSEST_OPS
            rejects += n_rej
            continue
        done = torch.zeros(sel.shape[0], dtype=torch.bool, device=rays.device)
        rej = woop.any_pretest_rejects(ws, ry)
        for c in range(ws.n_chunks):
            real = max(0, min(ws.chunk, ws.n_tris - c * ws.chunk))
            run = live[:, c * ws.chunk] & ~done
            t, u, v, ok = woop._project(ry, ws.tbl, ws.eps_any, c, ws.chunk)
            acc = (ok & (u >= 0) & (u <= 1.0) & (v >= 0) & (u + v <= 1.0)
                   & (t >= ry[:, 3:4]) & (t <= ry[:, 7:8]))[:, :real]
            has = acc.any(dim=1)
            first = torch.where(has, acc.int().argmax(dim=1) + 1, real)
            tst = (torch.arange(real, device=rays.device)[None, :] < first[:, None]) & run[:, None]
            cheap = tst & rej[:, c * ws.chunk:c * ws.chunk + real]
            total += int(tst.sum())
            rejects += int(cheap.sum())
            ops += int(tst.sum()) * ANY_OPS - int(cheap.sum()) * (ANY_OPS - REJECT_OPS)
            done |= run & has
    return total, ops, rejects


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
        pairs, n_ops, rejects = _pairs(ws, ry, m, first_end)
        nbytes = ry.shape[0] * (in_bytes + out_bytes) + 4 * (ws.tbl.numel() + ws.eps_any.numel() + m.numel())
        ops_s = n_ops / H100_FP32_OPS
        bytes_s = nbytes / H100_BYTES
        bound_ms = 1e3 * max(ops_s, bytes_s)
        print(f"{name}: {ry.shape[0]} rays, {pairs} live pairs, {n_ops} f32 operations, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({'operations' if ops_s >= bytes_s else 'bytes'}; "
              f"{1e3 * pairs * ops / H100_FP32_OPS:.4f} ms at {ops} a pair)")
        print(f"{name}: the interval pre-test rejects {rejects} of {pairs} live pairs ({rejects / max(pairs, 1):.4f}); "
              f"the bound counts {REJECT_OPS} operations for a rejected pair and {ops} for any other")
        out.append({"name": name, "route": "cuda", "source": "mcpt_tpu_torch/csrc/woop.cu",
                    "replaces": replaces, "launches": 0,
                    "max_abs_err": err if name == "woop_closest" else err_a,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": "operations" if ops_s >= bytes_s else "bytes",
                    "library_ms": None})
    if SAVE_BATCHES:
        _save(rc, "woop_closest_camera.pt")
    return out


def _save(rays, name):
    """Save a ray batch for time_closest_batch.py under --save-batches DIR."""
    import torch

    path = os.path.join(SAVE_BATCHES, name)
    torch.save(rays.cpu(), path)
    print(f"saved {rays.shape[0]} rays to {path}")


def _kernel_modules():
    from mcpt_tpu_torch.ops import schedule, select, traverse, woop

    return (("woop", woop), ("traverse", traverse), ("schedule", schedule), ("select", select))


def _reset_counts():
    for _, mod in _kernel_modules():
        for counts in (mod.LAUNCHES, mod.PLAIN_CALLS):
            for k in counts:
                counts[k] = 0


def _read_counts():
    """(launches, plain calls) of every kernel, keyed as in the kernels line."""
    launches, plain = {}, {}
    for name, mod in _kernel_modules():
        launches.update({f"{name}_{k}": v for k, v in mod.LAUNCHES.items()})
        plain.update({f"{name}_{k}": v for k, v in mod.PLAIN_CALLS.items()})
    return launches, plain


def drive_main_path(scene, label, width, height, passes, family):
    """Render `passes` passes of 1 spp at 24 bounces with every count set to
    0 first; fail unless the kernels of `family` launched, no other kernel
    did, no plain version ran, no NaN was scrubbed and the film is finite
    and positive. Returns the launches and the film."""
    import numpy as np

    from mcpt_tpu_torch.render.renderer import RenderConfig, Renderer

    r = Renderer(scene, RenderConfig(max_bounces=MAX_BOUNCES, width=width, height=height,
                                     spp_per_pass=1, seed=0))
    _reset_counts()
    for i in range(passes):
        r.step()
        print(f"pass {i}: {r.pass_times[-1]:.3f} s")
    launches, plain = _read_counts()
    st = r.stats
    img = r.film.accum / r.film.spp
    mean = [float(x) for x in img.mean(dim=(0, 1))]
    print(f"{label} {width}x{height}: launches {launches}, plain calls {plain}, traced rays "
          f"{st['traced_rays']:.0f}, {st['mrays_per_s']:.2f} Mrays/s, nan_scrubbed {st['nan_scrubbed']}, "
          f"mean RGB {mean}")
    mine = {k: v for k, v in launches.items() if k.startswith(family + "_")}
    others = {k: v for k, v in launches.items() if not k.startswith(family + "_")}
    if min(mine.values()) == 0 or max(others.values()) != 0 or max(plain.values()) != 0:
        raise AssertionError(f"{label} main path did not run through the {family} kernels alone: "
                             f"{launches}, plain {plain}")
    if st["nan_scrubbed"] != 0 or not all(np.isfinite(mean)) or min(mean) <= 0:
        raise AssertionError(f"bad film: nan_scrubbed {st['nan_scrubbed']}, mean {mean}")
    with tempfile.TemporaryDirectory() as tmp:
        path = r.save(os.path.join(tmp, f"{label}.png"))
        print(f"saved a {os.path.getsize(path)}-byte PNG")
    return launches, img


@phase("4 veach main path")
def main_path(scene):
    """Phase 4's render, keeping the arguments of the pass's first NEE
    shadow batch (its second any-hit launch: the first iteration has no
    shadow rays yet) and of its third closest-hit launch (the rays of its
    third wavefront iteration); then the any-hit and the closest-hit kernel
    against their plain versions on those batches (0 rays may differ,
    t/u/v bitwise), with times."""
    import torch

    from mcpt_tpu_torch.ops import woop

    store, restore = _capture(woop, "any_hit_woop_kernel", 2)
    store_c, restore_c = _capture(woop, "closest_hit_woop_kernel", 3)
    try:
        launches = drive_main_path(scene, "veach", WIDTH, HEIGHT, PASSES, "woop")[0]
    finally:
        restore_c()
        restore()
    ws, rays, mask = store["args"]
    k = woop.any_hit_woop_kernel(ws, rays, mask)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = woop.any_hit_woop_plain(ws, rays, mask)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    n_diff = int((k != p).sum())
    ms = cuda_time_ms(lambda: woop.any_hit_woop_kernel(ws, rays, mask))
    pairs, n_ops, _ = _pairs(ws, rays, mask, True)
    print(f"woop_any on the main path's first NEE shadow batch: {rays.shape[0]} rays, "
          f"{int(woop._active(rays).sum())} tested, occluded {float(p.float().mean()):.4f}, {n_diff} rays differ "
          f"from the plain version; {pairs} live pairs; kernel {ms:.4f} ms, plain {plain_ms:.1f} ms (one run), "
          f"bound {1e3 * n_ops / H100_FP32_OPS:.4f} ms (operations)")
    if n_diff:
        raise AssertionError(f"any-hit kernel differs from its plain version on {n_diff} rays of the main "
                             "path's shadow batch")

    ws, rays, mask = store_c["args"]
    if SAVE_BATCHES:
        _save(rays, "woop_closest_third.pt")
    k = woop.closest_hit_woop_kernel(ws, rays, mask)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = woop.closest_hit_woop_plain(ws, rays, mask)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    n_diff, bitwise, _ = _agreement("closest", k, p)
    ms = cuda_time_ms(lambda: woop.closest_hit_woop_kernel(ws, rays, mask))
    pairs, n_ops, rejects = _pairs(ws, rays, mask, False)
    print(f"woop_closest on the main path's third closest-hit batch: {rays.shape[0]} rays, "
          f"{int(woop._active(rays).sum())} tested, hits {float((p[1] >= 0).float().mean()):.4f}, {n_diff} rays "
          f"differ from the plain version (bitwise {bitwise}); {pairs} live pairs, the pre-test rejects {rejects} "
          f"({rejects / max(pairs, 1):.4f}); kernel {ms:.4f} ms, plain {plain_ms:.1f} ms (one run), bound "
          f"{1e3 * n_ops / H100_FP32_OPS:.4f} ms (operations; {1e3 * pairs * CLOSEST_OPS / H100_FP32_OPS:.4f} ms "
          f"at {CLOSEST_OPS} a pair)")
    if n_diff or not bitwise:
        raise AssertionError(f"closest-hit kernel differs from its plain version on {n_diff} rays (bitwise "
                             f"{bitwise}) of the main path's third closest-hit batch")
    return launches


@phase("5 small render, card vs CPU")
def small_reference(scene_cuda):
    """The same small render through the kernels and through the plain
    versions on the CPU: means within rtol 2e-3, >= 99 % of components
    within 1e-3 (tests/test_woop.py's render contract)."""
    from mcpt_tpu_torch.io.obj import load_scene
    from mcpt_tpu_torch.render.renderer import RenderConfig, Renderer

    imgs = []
    for scene in (scene_cuda, load_scene(VEACH, device="cpu")):
        r = Renderer(scene, RenderConfig(max_bounces=8, width=64, height=48, spp_per_pass=2, seed=1))
        r.step()
        imgs.append((r.film.accum / r.film.spp).cpu().numpy())
    _render_contract("veach 64x48x2spp", *imgs)


# ---------------------------------------------------------------------------
# bathroom-stress in memory
# ---------------------------------------------------------------------------

def _round6(x):
    """x as the OBJ writer's %.6f and the loader's float() leave it: the
    nearest multiple of 1e-6, ties to even on the exact binary value."""
    import numpy as np

    x = np.asarray(x, np.float64)
    y = x * 1e6
    k = np.rint(y)
    near = np.abs(np.abs(y - np.trunc(y)) - 0.5) < 1e-6  # x*1e6 may have rounded across .5
    if near.any():
        k[near] = [int(("%.6f" % v).replace(".", "")) for v in x[near]]
    return k / 1e6


def _unit_icosphere(subdiv=2):
    """Vertices and faces of scenes/generate.py's icosphere, in its order."""
    import numpy as np

    t = (1.0 + math.sqrt(5.0)) / 2.0
    base = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t), (0, 1, t),
            (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)]
    verts = [np.array(v) / np.linalg.norm(v) for v in base]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9), (5, 11, 4),
             (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8),
             (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    for _ in range(subdiv):
        cache, new = {}, []

        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = verts[i] + verts[j]
                verts.append(m / np.linalg.norm(m))
                cache[key] = len(verts) - 1
            return cache[key]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new
    return np.stack(verts), np.asarray(faces)


def stress_scene_arrays(target_tris=STRESS_TRIS, seed=0):
    """bathroom-stress without files: the arguments of the port's
    build_scene_host for what scenes/generate.py's gen_stress(target_tris,
    seed) writes and mcpt_tpu_torch.io.obj.load_scene reads back. Same
    triangles in the same order (room, tiled panel, mirror, height field,
    icospheres, ceiling light), positions, normals and uvs rounded as %.6f
    rounds them, the 256x256 checker texture, the camera and light of
    scenes/bathroom-stress.xml. Returns (vertices, normals, uvs, faces,
    mats, atlas, camera)."""
    import numpy as np

    pos, nrm, uvs, mat = [], [], [], []
    one_uv = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]])

    def quad(p, n, m, uv=((0, 0), (1, 0), (1, 1), (0, 1))):
        p, uv = np.asarray(p, np.float64), np.asarray(uv, np.float64)
        pos.append(p[[[0, 1, 2], [0, 2, 3]]])
        nrm.append(np.broadcast_to(np.asarray(n, np.float64), (2, 3, 3)))
        uvs.append(uv[[[0, 1, 2], [0, 2, 3]]])
        mat.append(np.full(2, m))

    walls = [((10, 0, 0), (0, 0, 0), (0, 0, 10), (10, 0, 10), (0, 1, 0)),
             ((10, 6, 0), (10, 6, 10), (0, 6, 10), (0, 6, 0), (0, -1, 0)),
             ((10, 0, 10), (0, 0, 10), (0, 6, 10), (10, 6, 10), (0, 0, -1)),
             ((0, 0, 10), (0, 0, 0), (0, 6, 0), (0, 6, 10), (1, 0, 0)),
             ((10, 0, 0), (10, 0, 10), (10, 6, 10), (10, 6, 0), (-1, 0, 0))]
    for *p, n in walls:
        quad(p, n, 0)
    quad([(9.5, 0.01, 0.5), (0.5, 0.01, 0.5), (0.5, 0.01, 9.5), (9.5, 0.01, 9.5)], (0, 1, 0), 1,
         uv=[(0, 0), (8, 0), (8, 8), (0, 8)])
    quad([(8, 1, 9.99), (2, 1, 9.99), (2, 5, 9.99), (8, 5, 9.99)], (0, 0, -1), 2)

    # height field: cells (i, j), i outer, two triangles a cell
    n = max(8, int(math.sqrt(int(target_tris * 0.7) / 2)))
    xs = np.linspace(1.0, 9.0, n + 1)
    zs = np.linspace(1.0, 9.0, n + 1)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    Y = 0.4 + 0.25 * np.sin(X * 3.1) * np.cos(Z * 2.7) + 0.1 * np.sin(X * 11 + Z * 7)
    dYdx = np.gradient(Y, xs, axis=0)
    dYdz = np.gradient(Y, zs, axis=1)
    N = np.stack([-dYdx, np.ones_like(dYdx), -dYdz], axis=-1)
    N = N / np.sqrt((N * N).sum(axis=-1, keepdims=True))
    P = np.stack([X, Y, Z], axis=-1)
    UV = np.stack(np.meshgrid(xs / 10.0, zs / 10.0, indexing="ij"), axis=-1)
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    i, j = i.reshape(-1), j.reshape(-1)
    # triangle A: (i,j) (i+1,j) (i+1,j+1); triangle B: (i,j) (i+1,j+1) (i,j+1)
    ci = np.stack([np.stack([i, i + 1, i + 1], 1), np.stack([i, i + 1, i], 1)], 1).reshape(-1, 3)
    cj = np.stack([np.stack([j, j, j + 1], 1), np.stack([j, j + 1, j + 1], 1)], 1).reshape(-1, 3)
    pos.append(P[ci, cj])
    nrm.append(N[ci, cj])
    uvs.append(UV[ci, cj])
    mat.append(np.full(ci.shape[0], 3))

    # icospheres
    rng = np.random.default_rng(seed)
    n_spheres = max(1, (target_tris - 2 * n * n - 16) // 320)
    u = rng.random((n_spheres, 4))  # per sphere: center (3 draws), then radius
    lo, hi = np.array([1.5, 1.2, 1.5]), np.array([8.5, 4.5, 8.5])
    cen = lo + (hi - lo) * u[:, :3]
    rad = 0.05 + (0.25 - 0.05) * u[:, 3]
    V, F = _unit_icosphere(2)
    pos.append((cen[:, None, None, :] + rad[:, None, None, None] * V[F][None]).reshape(-1, 3, 3))
    nrm.append(np.broadcast_to(V[F][None], (n_spheres,) + V[F].shape).reshape(-1, 3, 3))
    uvs.append(np.broadcast_to(one_uv, (n_spheres * F.shape[0], 3, 2)))
    mat.append(np.full(n_spheres * F.shape[0], 4))

    quad([(6.5, 5.98, 3.5), (3.5, 5.98, 3.5), (3.5, 5.98, 6.5), (6.5, 5.98, 6.5)], (0, -1, 0), 5)

    pos, nrm, uvs = (_round6(np.concatenate(x).reshape(-1, x[0].shape[-1])) for x in (pos, nrm, uvs))
    mat = np.concatenate(mat)
    T = mat.shape[0]
    idx = np.arange(3 * T, dtype=np.int32).reshape(T, 3)
    faces = np.stack([idx, idx, idx, np.broadcast_to(mat[:, None], (T, 3)).astype(np.int32)], axis=-1)

    kd = np.array([[0.7, 0.68, 0.65], [0.8, 0.8, 0.8], [0.0, 0.0, 0.0], [0.55, 0.5, 0.45],
                   [0.3, 0.45, 0.6], [0.8, 0.8, 0.8]])
    ks = np.zeros((6, 3))
    ks[2], ks[3] = (0.92, 0.94, 0.96), (0.2, 0.2, 0.2)
    ns = np.ones(6)
    ns[2], ns[3] = 10000.0, 80.0
    radiance = np.zeros((6, 3))
    radiance[5] = (22.0, 20.0, 17.0)
    mats = {"kd": kd, "ks": ks, "ns": ns, "tr": np.zeros((6, 3)), "ni": np.ones(6),
            "radiance": radiance, "tex_id": np.array([-1, 0, -1, -1, -1, -1], np.int32)}
    ij = np.arange(256)
    cx = (ij[:, None] * 8 // 256 + ij[None, :] * 8 // 256) % 2
    img = np.where(cx[..., None] == 0, np.array([235, 235, 230]), np.array([40, 60, 90])).astype(np.uint8)
    atlas = ((img.astype(np.float32) / 255.0) ** 2.2)[None], np.array([[256, 256]], np.int32)
    camera = {"width": 1280, "height": 720, "fovy": 55.0, "eye": np.array([5.0, 3.0, 0.3]),
              "lookat": np.array([5.0, 2.2, 5.0]), "up": np.array([0.0, 1.0, 0.0])}
    return pos, nrm, uvs, faces, mats, atlas, camera


def stress_scene(target_tris=STRESS_TRIS, seed=0, devices=("cuda",), verbose=False):
    """The in-memory bathroom-stress scene, BVH built, on each of `devices`."""
    from mcpt_tpu_torch.ops.bvh import attach_bvh
    from mcpt_tpu_torch.scene import build_scene_host, finalize_scene, to_device

    t0 = time.perf_counter()
    host = build_scene_host(*stress_scene_arrays(target_tris, seed))
    t1 = time.perf_counter()
    host = attach_bvh(host)
    t2 = time.perf_counter()
    scenes = [finalize_scene(to_device(host, dev)) for dev in devices]
    if scenes[0].device.type == "cuda":
        import torch

        torch.cuda.synchronize()
    t3 = time.perf_counter()
    if verbose:
        print(f"bathroom-stress: {host.num_tris} triangles, {host.bvh.lo.shape[0]} BVH nodes; "
              f"generate {t1 - t0:.2f} s, BVH build {t2 - t1:.2f} s, upload {t3 - t2:.2f} s")
    return scenes


@phase("6 bathroom-stress in memory")
def bathroom_scene():
    import torch

    from mcpt_tpu_torch.ops.traverse import STACK_SIZE, pack_traversal

    (scene,) = stress_scene(STRESS_TRIS, 0, ("cuda",), verbose=True)
    if scene.num_tris != 999_698:
        raise AssertionError(f"bathroom-stress has {scene.num_tris} triangles, not 999,698")
    g = scene.geom
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts = pack_traversal(scene.bvh, g.v0, g.e1, g.e2)
    torch.cuda.synchronize()
    same = all(torch.equal(getattr(ts, k).view(torch.int32), getattr(scene.trav, k).view(torch.int32))
               for k in ("nodes", "tris", "pairs"))  # bits: a skip of -1 reads as NaN
    print(f"traversal tables packed in {time.perf_counter() - t0:.3f} s on the card: child-pair table "
          f"{ts.pairs.shape[0]} rows ({ts.pairs.numel() * 4 / 1e6:.1f} MB), depth {ts.depth} (the kernel's "
          f"stack holds {64 if ts.depth <= 64 else STACK_SIZE}); the same as the scene's {same}")
    if not same:
        raise AssertionError("packing the traversal tables again gave other tables")
    return scene


def _check_any(label, ts, rays):
    """The any-hit kernel's answer on `rays` against its plain version
    (any_hit_ordered_plain) and the skip-link walk: 0 rays may differ.
    Prints the walks' visits and tests; returns the plain answer, the
    skip-link walk's counts (the bound's), the plain version's wall ms (one
    run) and the largest difference of the kernel's answer from either
    walk's, as 0 or 1."""
    import torch

    from mcpt_tpu_torch.ops import traverse as tv

    skip, skip_counts, skip_ms = _walk_plain(tv.any_hit_traverse_plain, ts, rays)
    p, own, plain_ms = _walk_plain(tv.any_hit_ordered_plain, ts, rays)
    k = tv.any_hit_traverse_kernel(ts, rays)
    torch.cuda.synchronize()
    R = rays.shape[0]
    diffs = {"skip-link walk": int((p != skip).sum()), "kernel": int((k != p).sum())}
    err = max(float((k.int() - w.int()).abs().max()) if R else 0.0 for w in (p, skip))
    print(f"traverse_any ({label}): {R} rays, occluded {float(p.float().mean()):.4f}; rays differing from the plain "
          f"version: {diffs}; child-pair visits {own['pair_visits']} ({own['pair_visits'] / R:.2f} a ray), "
          f"triangle tests {own['tri_tests']} ({own['tri_tests'] / R:.2f}); plain {plain_ms:.1f} ms (one run); "
          f"skip-link walk {skip_counts['node_visits']} node visits ({skip_counts['node_visits'] / R:.2f}), "
          f"{skip_counts['tri_tests']} triangle tests ({skip_counts['tri_tests'] / R:.2f}), {skip_ms:.1f} ms")
    if any(diffs.values()):
        raise AssertionError(f"traverse_any differs on the {label} batch: {diffs}")
    return p, skip_counts, plain_ms, err


def _traversal_bound(kind, counts, rays, ts):
    """Least time (ms) for this batch and what sets it: this run's node visits
    and triangle tests times their f32 operations over the FP32 rate, or the
    bytes of each input read once (rays, node and triangle tables) and each
    output written once over the memory rate."""
    R = rays.shape[0]
    ops = counts["node_visits"] * TRAV_NODE_OPS[kind] + counts["tri_tests"] * TRAV_TRI_OPS[kind]
    nbytes = R * (32 + (16 if kind == "closest" else 1)) + 4 * (ts.nodes.numel() + ts.tris.numel())
    ops_s, bytes_s = ops / H100_FP32_OPS, nbytes / H100_BYTES
    return 1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def _check_ordered(label, ts, rays, kern_out):
    """The closest-hit kernel's answer on `rays` against its plain version
    (the ordered walk, 0 rays may differ, t/u/v bitwise) and the skip-link
    walk (at most ROUTE_DIFF_MAX rays may differ; each printed with both t
    and ids). Returns the plain answer, the skip-link walk's counts (the
    bound's) and the plain version's wall ms (one run)."""
    import torch

    from mcpt_tpu_torch.ops import traverse as tv

    skip, skip_counts, skip_ms = _walk_plain(tv.closest_hit_traverse_plain, ts, rays)
    p, own, plain_ms = _walk_plain(tv.closest_hit_ordered_plain, ts, rays)
    n_diff = int((kern_out[1] != p[1]).sum())
    bitwise = all(torch.equal(a, b) for a, b in zip(kern_out, p))
    route = torch.nonzero(p[1] != skip[1])[:, 0].tolist()
    R = rays.shape[0]
    print(f"traverse_closest ({label}): {R} rays, hits {float((p[1] >= 0).float().mean()):.4f}, {n_diff} rays "
          f"differ from the plain version (bitwise {bitwise}); ordered walk {own['pair_visits']} child-pair "
          f"visits ({own['pair_visits'] / R:.2f} a ray), {own['tri_tests']} triangle tests "
          f"({own['tri_tests'] / R:.2f}), plain {plain_ms:.1f} ms (one run); skip-link walk "
          f"{skip_counts['node_visits']} node visits ({skip_counts['node_visits'] / R:.2f}), "
          f"{skip_counts['tri_tests']} triangle tests ({skip_counts['tri_tests'] / R:.2f}), {skip_ms:.1f} ms; "
          f"{len(route)} rays differ between the two walks")
    for i in route[:ROUTE_DIFF_MAX + 1]:
        print(f"  ray {i}: skip-link t {float(skip[0][i])!r} id {int(skip[1][i])}, ordered t "
              f"{float(p[0][i])!r} id {int(p[1][i])}")
    if n_diff or not bitwise:
        raise AssertionError(f"traverse_closest kernel differs from its plain version on {n_diff} rays "
                             f"(bitwise {bitwise}) of the {label} batch")
    if len(route) > ROUTE_DIFF_MAX:
        raise AssertionError(f"the ordered walk differs from the skip-link walk on {len(route)} rays of the "
                             f"{label} batch (at most {ROUTE_DIFF_MAX} may)")
    return p, skip_counts, plain_ms


@phase("7 traversal kernels vs plain")
def check_traversal(scene):
    """Each traversal kernel against its plain version on the same sorted
    batch (the main path's order): 0 rays may differ, t/u/v bitwise. Closest
    hit on the scene camera's rays, any hit on shadow rays from their hits to
    points on the light; each kernel's walk of the child-pair table also
    against the skip-link walk. Returns the kernels' entries, the two batches
    (packed, in pixel order) and the skip-link walks' counts on each."""
    import torch

    from mcpt_tpu_torch.ops import traverse as tv
    from mcpt_tpu_torch.ops.woop import F32_MAX, pack_rays
    from mcpt_tpu_torch.render.camera import generate_rays
    from mcpt_tpu_torch.render.integrator import RAY_EPS_REL, pack_light_table, sample_light_point

    dev = scene.device
    ts = scene.trav
    g = torch.Generator(device=dev).manual_seed(0)
    cam = scene.camera
    R = cam.width * cam.height
    o, d = generate_rays(cam, torch.rand((R, 2), generator=g, device=dev), torch.arange(R, device=dev))
    t_min = RAY_EPS_REL * scene.scale
    batches = {"closest": pack_rays(o, d, t_min, F32_MAX)}

    def sort(rays):
        order = tv.ray_sort_order(ts, rays[:, 0:3], rays[:, 4:7])
        return rays[order].contiguous(), order

    out, results, walks = [], {}, {}
    for kind in ("closest", "any"):
        if kind == "any":  # shadow rays from the closest hits (pixel order) to the light
            t, tri = results["closest"]
            hit = tri >= 0
            pts = (o + d * t[:, None])[hit]
            u = torch.rand((pts.shape[0], 3), generator=g, device=dev)
            lp = sample_light_point(pack_light_table(scene), scene.num_lights, u[:, 0], u[:, 1], u[:, 2])[0]
            sv = lp - pts
            dist = sv.norm(dim=1)
            batches["any"] = pack_rays(pts, sv / dist[:, None], t_min, dist * (1 - 1e-3))
        rays = batches[kind]
        srt, order = sort(rays)
        kern = getattr(tv, f"{kind}_hit_traverse_kernel")
        if kind == "closest":
            k = kern(ts, srt)
            torch.cuda.synchronize()
            p, walks[kind], plain_ms = _check_ordered("camera", ts, srt, k)
            err = 0.0  # _check_ordered holds t, u, v and the ids bit for bit
            back_t, back_tri = torch.empty_like(p[0]), torch.empty_like(p[1])
            back_t[order], back_tri[order] = p[0], p[1]
            results["closest"] = (back_t, back_tri)
        else:
            _, walks[kind], plain_ms, err = _check_any("shadow", ts, srt)
            if SAVE_BATCHES:
                _save(srt, "traverse_any_shadow.pt")
        ms = cuda_time_ms(lambda: kern(ts, srt))
        ms_unsorted = cuda_time_ms(lambda: kern(ts, rays))
        bound_ms, by = _traversal_bound(kind, walks[kind], srt, ts)
        print(f"traverse_{kind}: kernel {ms:.4f} ms sorted, {ms_unsorted:.4f} ms unsorted "
              f"({ms_unsorted / ms:.2f}x), plain {plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({by}; the "
              f"skip-link walk's visits and tests)")
        out.append({"name": f"traverse_{kind}", "route": "cuda", "source": "mcpt_tpu_torch/csrc/traverse.cu",
                    "replaces": "mcpt_tpu/ops/pallas/traverse.py:" + ("128" if kind == "closest" else "347"),
                    "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": by, "library_ms": None})
    return out, batches, walks


@phase("8 bathroom main path")
def bathroom_main_path(scene):
    """Phase 8's render, keeping the arguments of the pass's third
    closest-hit and third any-hit launches (the rays of its third wavefront
    iteration, and of the third shadow launch); then each kernel against its
    plain version and the skip-link walk on its batch, with times."""
    import torch

    from mcpt_tpu_torch.ops import traverse as tv

    store, restore = _capture(tv, "closest_hit_traverse_kernel", 3)
    store_a, restore_a = _capture(tv, "any_hit_traverse_kernel", 3)
    try:
        out = drive_main_path(scene, "bathroom", BATH_W, BATH_H, BATH_PASSES, "traverse")
    finally:
        restore_a()
        restore()
    ts, rays = store["args"]
    if SAVE_CLOSEST_BATCH:
        torch.save(rays.cpu(), SAVE_CLOSEST_BATCH)
        print(f"saved the third-iteration closest batch to {SAVE_CLOSEST_BATCH}")
    if SAVE_BATCHES:
        _save(rays, "traverse_closest_third.pt")
    k = tv.closest_hit_traverse_kernel(ts, rays)
    _, counts, _ = _check_ordered("main path, third iteration", ts, rays, k)
    ms = cuda_time_ms(lambda: tv.closest_hit_traverse_kernel(ts, rays))
    bound_ms, by = _traversal_bound("closest", counts, rays, ts)
    print(f"traverse_closest (main path, third iteration): kernel {ms:.4f} ms, bound {bound_ms:.4f} ms ({by})")

    ts, rays = store_a["args"]
    if SAVE_BATCHES:
        _save(rays, "traverse_any_third.pt")
    _, counts, _, _ = _check_any("main path, third launch", ts, rays)
    ms = cuda_time_ms(lambda: tv.any_hit_traverse_kernel(ts, rays))
    bound_ms, by = _traversal_bound("any", counts, rays, ts)
    print(f"traverse_any (main path, third launch): kernel {ms:.4f} ms, bound {bound_ms:.4f} ms ({by})")
    return out, {"closest": store["args"][1], "any": rays}


# ---------------------------------------------------------------------------
# treelet layout, schedule and select kernels
# ---------------------------------------------------------------------------

@phase("10 treelet layout")
def treelet_layout(scene):
    """Build bathroom-stress's treelet layout again from its BVH, timed; it
    must equal the one attach_bvh built, sub-BVH arrays included, and have
    136 superblocks, 17,408 rows and 11,471 real treelets."""
    import torch

    from mcpt_tpu_torch.ops.treelets import build_treelets

    bvh = {k: getattr(scene.bvh, k).cpu().numpy() for k in ("lo", "hi", "first", "count", "skip")}
    t0 = time.perf_counter()
    tl = build_treelets(bvh, scene.num_tris)
    sec = time.perf_counter() - t0
    real = int((tl.row_count > 0).sum())
    print(f"treelets: built in {sec:.3f} s; NS {tl.ns}, NSp {tl.nsp}, G {tl.g}, real rows {real} "
          f"({scene.num_tris / real:.1f} triangles a treelet, c {tl.c}, s_b {tl.s_b}); sub-BVHs "
          f"{int(tl.row_pair_count.sum())} child-pair rows, tdepth {tl.tdepth}")
    same = tl.tdepth == scene.treelets.tdepth and all(
        torch.equal(torch.as_tensor(getattr(tl, k)), getattr(scene.treelets, k).cpu())
        for k in ("sb_box", "blk_box", "row_first", "row_count", "row_pair_first", "row_pair_count", "row_root"))
    if (tl.ns, tl.g, real) != (136, 17_408, 11_471) or not same:
        raise AssertionError(f"unexpected layout: NS {tl.ns}, G {tl.g}, real {real}, same as the scene's {same}")


def _scrambled_batch(scene, n, seed=1):
    """tools/bench_schedule.py make_batches' second batch: origins uniform
    in 1.2 times the scene box about its centre, directions uniform."""
    import torch

    from mcpt_tpu_torch.ops.woop import F32_MAX, pack_rays
    from mcpt_tpu_torch.render.integrator import RAY_EPS_REL

    dev = scene.device
    g = torch.Generator(device=dev).manual_seed(seed)
    lo, hi = scene.trav.nodes[0, 0:3], scene.trav.nodes[0, 4:7]
    o = (lo + hi) / 2 + (torch.rand((n, 3), generator=g, device=dev) * 1.2 - 0.6) * (hi - lo)
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g, device=dev), dim=1)
    return pack_rays(o, d, RAY_EPS_REL * scene.scale, F32_MAX)


def _sorted_tiles(scene, rays):
    """Packed rays as the treelet wrappers launch them: sorted, whole tiles."""
    from mcpt_tpu_torch.ops.schedule import sorted_tiles

    return sorted_tiles(scene, rays[:, 0:3], rays[:, 4:7], rays[:, 3], rays[:, 7])[0]


def _agreement(kind, k, p):
    """(rays whose results differ, bitwise, max abs error of t/u/v where the
    ids agree) of a kernel's output against another's."""
    import torch

    if kind == "any":
        n = int((k != p).sum())
        return n, n == 0, float((k.int() - p.int()).abs().max())
    both = (k[1] == p[1]) & (p[1] >= 0)
    err = max(float((a[both] - b[both]).abs().max()) if both.any() else 0.0
              for a, b in ((k[0], p[0]), (k[2], p[2]), (k[3], p[3])))
    return int((k[1] != p[1]).sum()), all(torch.equal(a, b) for a, b in zip(k, p)), err


def _examples(kind, got, want, n=4):
    """A few rays whose answer differs, as text."""
    import torch

    if kind == "any":
        idx = torch.nonzero(got != want)[:n, 0].tolist()
        return [(i, bool(got[i]), bool(want[i])) for i in idx]
    idx = torch.nonzero(got[1] != want[1])[:n, 0].tolist()
    return [(i, int(got[1][i]), float(got[0][i]), int(want[1][i]), float(want[0][i])) for i in idx]


def _packet_bound(kind, counts, rays, scene, extra_bytes):
    """Least time (ms) of a treelet kernel's own algorithm: its triangle
    tests (every tested ray of a block against every triangle of every
    treelet the block visits) and entry keys times their f32 operations
    over the FP32 rate, or its inputs read once and outputs written once
    over the memory rate, whichever is longer. Printed beside bound_ms,
    which is the function's (the BVH walk's tests on the same rays)."""
    ops = counts.get("tri_tests", 0) * TREELET_TRI_OPS[kind] + counts.get("box_keys", 0) * TREELET_KEY_OPS
    tl = scene.treelets
    nbytes = (rays.shape[0] * (32 + (16 if kind == "closest" else 1)) + 4 * scene.trav.tris.numel()
              + 4 * (tl.row_first.numel() + tl.row_count.numel()) + extra_bytes)
    return 1e3 * max(ops / H100_FP32_OPS, nbytes / H100_BYTES)


def _check_route(name, label, n_trav, other="traverse.cu"):
    if n_trav > ROUTE_DIFF_MAX:
        raise AssertionError(f"{name} answers differently from {other} on {n_trav} rays of the {label} "
                             f"batch (at most {ROUTE_DIFF_MAX} may)")


def _walk_plain(plain, *args):
    """One plain walk with its counts, and its wall ms (the device synced)."""
    import torch

    counts = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = plain(*args, counts)
    torch.cuda.synchronize()
    return p, counts, 1e3 * (time.perf_counter() - t0)


@phase("11 schedule kernels vs plain")
def check_schedule(scene, batches, walks):
    """Per 921,600-ray batch (the camera rays and shadow rays of phase 7,
    and a scrambled batch that fills the fallback): the pre-pass kernel
    against its plain version (keys, incomplete tiles and live counts
    bitwise); the walk kernel against its plain walk (0 rays may differ,
    t/u/v bitwise; every tile, every SCRAMBLED_STRIDE-th of the scrambled
    batch) and the reference (packet) walk on the same tiles and, as
    the whole function (kernel, then traverse.cu on the incomplete tiles'
    rays), against traverse.cu (at most ROUTE_DIFF_MAX rays may differ
    each, examples printed); both walks' counts, and on camera rays the
    walk must make at most a fifth of the packet walk's triangle tests.
    Times the pre-pass, the kernel, the fallback and the whole entry point
    (sort, pre-pass, kernel, fallback, scatter) beside traverse.cu's. bound_ms
    is the function's: the BVH walk's node visits and triangle tests on the
    same rays (phase 7's counts, or a plain walk of the scrambled batch);
    the walk bound (this kernel's counts) and packet-test bound (the
    reference walk's) are printed beside it."""
    import torch

    from mcpt_tpu_torch.ops import schedule as S
    from mcpt_tpu_torch.ops import traverse as tv

    tl, ts = scene.treelets, scene.trav
    out = []
    cases = (("camera", "closest", batches["closest"]), ("shadow", "any", batches["any"]),
             ("scrambled", "closest", _scrambled_batch(scene, batches["closest"].shape[0])))
    for label, kind, rays in cases:
        srt = _sorted_tiles(scene, rays)
        # the pre-pass
        sched, inc, n_live = S.build_schedule_kernel(tl, srt, SCHED_V)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want_sched = S.build_schedule_plain(tl, srt, SCHED_V)
        torch.cuda.synchronize()
        prepass_plain_ms = 1e3 * (time.perf_counter() - t0)
        pre_counts = {}
        culled = S.build_schedule_plain(tl, srt, SCHED_V, cull=True, counts=pre_counts)
        pre_bitwise = all(torch.equal(a, b) for a, b in zip((sched, inc, n_live), want_sched))
        pre_mirror = all(torch.equal(a, b) for a, b in zip(culled, want_sched))
        n_rows = int((sched != want_sched[0]).any(dim=1).sum())
        if SAVE_BATCHES:
            _save(srt, f"schedule_{kind}_{label}.pt")
            _save(sched, f"schedule_{kind}_{label}_rows.pt")
        nl = n_live.float()
        n_inc = int(inc.sum())
        # the walks: the kernel on every tile; the plain walks on every tile
        # of the camera and shadow batches and on every SCRAMBLED_STRIDE-th
        # tile of the scrambled one (the plain walk's loop takes the longest
        # there)
        kern = getattr(S, f"{kind}_hit_schedule_kernel")
        k = kern(tl, ts, srt, sched)
        tiles = torch.arange(0, sched.shape[0], SCRAMBLED_STRIDE if label == "scrambled" else 1, device=srt.device)
        ray_ids = (tiles[:, None] * S.RAY_TILE + torch.arange(S.RAY_TILE, device=srt.device)).reshape(-1)
        sub, sub_sched = srt[ray_ids], sched[tiles].contiguous()
        k_sub = tuple(x[ray_ids] for x in k) if kind == "closest" else k[ray_ids]
        p, counts, plain_ms = _walk_plain(getattr(S, f"{kind}_hit_schedule_plain"), tl, ts, sub, sub_sched)
        ref, ref_counts, ref_ms = _walk_plain(getattr(S, f"{kind}_hit_schedule_packet_plain"), tl, ts, sub,
                                              sub_sched)
        n_diff, bitwise, err = _agreement(kind, k_sub, p)
        n_ref = _agreement(kind, k_sub, ref)[0]
        inc_ids = S.incomplete_rays(inc)
        fb = srt[inc_ids]  # the fallback's rays, as the entry point takes them
        trav = getattr(tv, f"{kind}_hit_traverse_kernel")
        f = trav(ts, fb)
        whole = tuple(x.clone() for x in k) if kind == "closest" else k.clone()
        for a, b in zip(whole, f) if kind == "closest" else ((whole, f),):
            a[inc_ids] = b
        want = trav(ts, srt)
        n_trav = _agreement(kind, whole, want)[0]
        # times
        prepass_ms = cuda_time_ms(lambda: S.build_schedule_kernel(tl, srt, SCHED_V))
        ms = cuda_time_ms(lambda: kern(tl, ts, srt, sched))
        fallback_ms = cuda_time_ms(lambda: trav(ts, fb)) if n_inc else 0.0
        trav_ms = cuda_time_ms(lambda: trav(ts, srt))
        args = (rays[:, 0:3], rays[:, 4:7], rays[:, 3], rays[:, 7])
        whole_ms = cuda_time_ms(lambda: getattr(S, f"{kind}_hit_schedule")(scene, *args, v=SCHED_V))
        trav_whole_ms = cuda_time_ms(lambda: getattr(tv, f"{kind}_hit_traverse")(ts, *args))
        # bounds
        trav_counts = (_walk_plain(tv.closest_hit_traverse_plain, ts, srt)[1] if label == "scrambled"
                       else walks[kind])
        bound_ms, by = _traversal_bound(kind, trav_counts, srt, ts)
        walk_ms = _walk_bound(kind, counts, sub, scene, 4 * sub_sched.numel())
        packet_ms = _packet_bound(kind, ref_counts, sub, scene, 4 * sub_sched.numel())
        pre_bound_ms, pre_by = _prepass_bound(pre_counts, srt, scene, sched)
        tested = int(((sub[:, 3] < sub[:, 7]) & (sub[:, 0:3].abs() < 1e29).all(dim=1)).sum())
        per = max(tested, 1)
        print(f"schedule_prepass ({label}): {rays.shape[0]} rays, {sched.shape[0]} tiles, {n_inc} incomplete, "
              f"live treelets a tile p50 {float(nl.quantile(0.5)):.0f} p99 {float(nl.quantile(0.99)):.0f} max "
              f"{int(n_live.max())}; kernel equals the plain version bitwise {pre_bitwise} ({n_rows} rows differ), "
              f"the culled mirror equals it {pre_mirror}; {pre_counts['box_tests']} box tests "
              f"({pre_counts['box_tests'] / sched.shape[0]:.1f} a tile); kernel {prepass_ms:.4f} ms, plain "
              f"{prepass_plain_ms:.1f} ms (one run), bound {pre_bound_ms:.4f} ms ({pre_by})")
        print(f"schedule_{kind} ({label}): the plain walks on {tiles.shape[0]} of {sched.shape[0]} tiles, {tested} "
              f"tested rays; {n_diff} rays differ from the plain walk (bitwise {bitwise}, max abs err {err:.3g}); "
              f"{n_ref} differ from the packet walk{' e.g. ' + str(_examples(kind, k_sub, ref)) if n_ref else ''}; "
              f"{n_trav} differ from traverse.cu on every tile"
              f"{' e.g. ' + str(_examples(kind, whole, want)) if n_trav else ''}")
        print(f"schedule_{kind} ({label}): walk {counts.get('treelet_visits', 0)} treelet visits, "
              f"{counts.get('pair_visits', 0)} child-pair visits ({counts.get('pair_visits', 0) / per:.2f} a tested "
              f"ray), {counts.get('tri_tests', 0)} triangle tests ({counts.get('tri_tests', 0) / per:.2f}), "
              f"{counts.get('box_keys', 0)} entry keys ({counts.get('box_keys', 0) / per:.2f}); packet walk "
              f"{ref_counts.get('treelet_visits', 0)} treelet visits, {ref_counts.get('tri_tests', 0)} triangle tests "
              f"({ref_counts.get('tri_tests', 0) / per:.2f})")
        print(f"schedule_{kind} ({label}): pre-pass {prepass_ms:.4f} ms, kernel {ms:.4f} ms, fallback "
              f"{fallback_ms:.4f} ms; the whole {kind}_hit_schedule {whole_ms:.4f} ms against {kind}_hit_traverse "
              f"{trav_whole_ms:.4f} ms (traverse.cu alone {trav_ms:.4f} ms); plain walk {plain_ms:.1f} ms, packet "
              f"walk {ref_ms:.1f} ms (one run each); bound {bound_ms:.4f} ms ({by}; the BVH walk's tests), walk "
              f"bound {walk_ms:.4f} ms (this kernel's counts), packet-test bound {packet_ms:.4f} ms (the packet "
              f"walk's)")
        if not (pre_bitwise and pre_mirror):
            raise AssertionError(f"schedule_prepass kernel differs from its plain version on {n_rows} rows (culled "
                                 f"mirror equal {pre_mirror}) of the {label} batch")
        if n_diff or not bitwise:
            raise AssertionError(f"schedule_{kind} kernel differs from its plain walk on {n_diff} rays "
                                 f"(bitwise {bitwise}) of the {label} batch")
        _check_route(f"schedule_{kind}", label, n_ref, "the packet walk")
        _check_route(f"schedule_{kind}", label, n_trav)
        if label == "camera" and 5 * counts.get("tri_tests", 0) > ref_counts.get("tri_tests", 0):
            raise AssertionError(f"schedule_closest makes {counts['tri_tests']} triangle tests on camera rays, more "
                                 f"than a fifth of the packet walk's {ref_counts['tri_tests']}")
        if label == "scrambled":
            continue
        if label == "camera":
            out.append({"name": "schedule_prepass", "route": "cuda", "source": "mcpt_tpu_torch/csrc/treelet.cu",
                        "replaces": "none: not a TPU kernel (the XLA pre-pass build_schedule, "
                                    "mcpt_tpu/ops/pallas/schedule.py:164)",
                        "launches": 0, "max_abs_err": float((sched.long() - want_sched[0].long()).abs().max()),
                        "ms": prepass_ms,
                        "plain_ms": prepass_plain_ms, "bound_ms": pre_bound_ms, "bound_by": pre_by,
                        "library_ms": None})
        out.append({"name": f"schedule_{kind}", "route": "cuda", "source": "mcpt_tpu_torch/csrc/treelet.cu",
                    "replaces": "mcpt_tpu/ops/pallas/schedule.py:" + ("253" if kind == "closest" else "361"),
                    "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": by, "library_ms": None})
    return out


def _prepass_bound(counts, rays, scene, sched):
    """Least time (ms) of the pre-pass on this batch and what sets it: its
    (tile, box) interval tests (the superblock cull's, counted by
    build_schedule_plain(cull=True)) times PREPASS_BOX_OPS over the FP32
    rate, or the rays and box tables read once and the rows, flags and
    counts written once over the memory rate."""
    tl = scene.treelets
    n_tiles = sched.shape[0]
    ops = counts["box_tests"] * PREPASS_BOX_OPS
    nbytes = (32 * rays.shape[0] + 4 * (tl.sb_box.numel() + tl.blk_box.numel()) + 4 * sched.numel()
              + 5 * n_tiles)
    ops_s, bytes_s = ops / H100_FP32_OPS, nbytes / H100_BYTES
    return 1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def _walk_bound(kind, counts, rays, scene, extra_bytes=0):
    """Least time (ms) of a treelet walk's own algorithm (select, or the
    schedule walk with its rows' `extra_bytes`) on this batch: its
    child-pair row visits, triangle tests and entry keys times their f32
    operations over the FP32 rate, or its inputs read once and outputs
    written once over the memory rate, whichever is longer."""
    ops = (counts.get("pair_visits", 0) * TRAV_NODE_OPS[kind] + counts.get("tri_tests", 0) * TREELET_TRI_OPS[kind]
           + counts.get("box_keys", 0) * TREELET_KEY_OPS)
    tl, ts = scene.treelets, scene.trav
    nbytes = (rays.shape[0] * (32 + (16 if kind == "closest" else 1)) + 4 * (ts.tris.numel() + ts.pairs.numel())
              + 4 * (tl.sb_box.numel() + tl.blk_box.numel() + 5 * tl.row_first.numel()) + extra_bytes)
    return 1e3 * max(ops / H100_FP32_OPS, nbytes / H100_BYTES)


@phase("12 select kernels vs plain")
def check_select(scene, batches, walks, thirds):
    """The select kernels on the camera and shadow batches of phase 7:
    against their plain walks (0 rays may differ, t/u/v bitwise), the
    reference walk (every tested ray of a tile against every triangle of
    every treelet it visits) and traverse.cu (at most ROUTE_DIFF_MAX rays
    may differ each, examples printed); both walks' counts, and on camera
    rays the walk must make at most a fifth of the reference walk's
    triangle tests. On phase 8's third closest and third any-hit batches
    against traverse.cu. Times each kernel on each batch; bound_ms as in
    phase 11, beside the bounds of both walks' own counts."""
    from mcpt_tpu_torch.ops import select as SL
    from mcpt_tpu_torch.ops import traverse as tv

    tl, ts = scene.treelets, scene.trav
    print(f"treelets: tdepth {tl.tdepth} (the kernels' stack holds {16 if tl.tdepth <= 16 else tv.STACK_SIZE}), "
          f"child-pair rows a treelet p50 {float(tl.row_pair_count[tl.row_count > 0].float().quantile(0.5)):.0f} "
          f"max {int(tl.row_pair_count.max())}")
    out = []
    cases = (("camera", "closest", batches["closest"]), ("shadow", "any", batches["any"]),
             ("main path, third iteration", "closest", thirds["closest"]),
             ("main path, third launch", "any", thirds["any"]))
    for label, kind, rays in cases:
        srt = _sorted_tiles(scene, rays)
        first = label in ("camera", "shadow")
        if SAVE_BATCHES:
            _save(srt, f"select_{kind}_{label if first else 'third'}.pt")
        kern = getattr(SL, f"{kind}_hit_select_kernel")
        k = kern(tl, ts, srt)
        want = getattr(tv, f"{kind}_hit_traverse_kernel")(ts, srt)
        n_trav = _agreement(kind, k, want)[0]
        ms = cuda_time_ms(lambda: kern(tl, ts, srt))
        print(f"select_{kind} ({label}): {srt.shape[0]} rays; kernel {ms:.4f} ms; {n_trav} rays differ from "
              f"traverse.cu{' e.g. ' + str(_examples(kind, k, want)) if n_trav else ''}")
        _check_route(f"select_{kind}", label, n_trav)
        if not first:
            continue
        p, counts, plain_ms = _walk_plain(getattr(SL, f"{kind}_hit_select_plain"), tl, ts, srt)
        ref, ref_counts, ref_ms = _walk_plain(getattr(SL, f"{kind}_hit_select_packet_plain"), tl, ts, srt)
        n_diff, bitwise, err = _agreement(kind, k, p)
        n_ref = _agreement(kind, k, ref)[0]
        tested = int(((srt[:, 3] < srt[:, 7]) & (srt[:, 0:3].abs() < 1e29).all(dim=1)).sum())
        per = max(tested, 1)
        bound_ms, by = _traversal_bound(kind, walks[kind], srt, ts)
        print(f"select_{kind} ({label}): {tested} tested rays; {n_diff} rays differ from the plain walk (bitwise "
              f"{bitwise}, max abs err {err:.3g}); {n_ref} differ from the reference walk"
              f"{' e.g. ' + str(_examples(kind, k, ref)) if n_ref else ''}")
        print(f"select_{kind} ({label}): walk {counts['treelet_visits']} treelet visits, {counts['pair_visits']} "
              f"child-pair visits ({counts['pair_visits'] / per:.2f} a tested ray), {counts['tri_tests']} triangle "
              f"tests ({counts['tri_tests'] / per:.2f}), {counts['box_keys']} entry keys "
              f"({counts['box_keys'] / per:.2f}); reference walk {ref_counts['treelet_visits']} treelet visits, "
              f"{ref_counts['tri_tests']} triangle tests ({ref_counts['tri_tests'] / per:.2f}), "
              f"{ref_counts['box_keys']} entry keys ({ref_counts['box_keys'] / per:.2f})")
        print(f"select_{kind} ({label}): plain walk {plain_ms:.1f} ms, reference walk {ref_ms:.1f} ms (one run each); "
              f"bound {bound_ms:.4f} ms ({by}; the BVH walk's tests), walk bound "
              f"{_walk_bound(kind, counts, srt, scene):.4f} ms (this kernel's counts), packet-test bound "
              f"{_packet_bound(kind, ref_counts, srt, scene, 4 * (tl.sb_box.numel() + tl.blk_box.numel())):.4f}"
              f" ms (the reference walk's)")
        if n_diff or not bitwise:
            raise AssertionError(f"select_{kind} kernel differs from its plain walk on {n_diff} rays "
                                 f"(bitwise {bitwise}) of the {label} batch")
        _check_route(f"select_{kind}", label, n_ref, "the reference walk")
        if label == "camera" and 5 * counts["tri_tests"] > ref_counts["tri_tests"]:
            raise AssertionError(f"select_closest makes {counts['tri_tests']} triangle tests on camera rays, more "
                                 f"than a fifth of the reference walk's {ref_counts['tri_tests']}")
        out.append({"name": f"select_{kind}", "route": "cuda", "source": "mcpt_tpu_torch/csrc/treelet.cu",
                    "replaces": "mcpt_tpu/ops/pallas/select.py:" + ("80" if kind == "closest" else "258"),
                    "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": by, "library_ms": None})
    return out


@phase("13 bathroom main path, select kernels")
def bathroom_select_path(scene, film8):
    """Phase 8's render with MCPT_TREELET_SELECT=smem dispatch: only the
    select kernels launch; the film against phase 8's, pixel by pixel (at
    most ROUTE_DIFF_MAX pixels may differ)."""
    from mcpt_tpu_torch.ops import intersect

    intersect.TREELET_SELECT = "smem"
    try:
        launches, img = drive_main_path(scene, "bathroom-select", BATH_W, BATH_H, BATH_PASSES, "select")
    finally:
        intersect.TREELET_SELECT = "vote"
    diff = (img != film8).any(dim=-1)
    print(f"film against phase 8's: {int(diff.sum())} of {diff.numel()} pixels differ, max abs difference "
          f"{float((img - film8).abs().max()):.3g}")
    if int(diff.sum()) > ROUTE_DIFF_MAX:
        raise AssertionError(f"{int(diff.sum())} pixels differ from phase 8's film (at most {ROUTE_DIFF_MAX} may)")
    return launches


def _render_contract(label, a, b):
    """>= 99 % of components within 1e-3 and channel means within rtol 2e-3
    (tests/test_woop.py's render contract)."""
    import numpy as np

    close = float(np.isclose(a, b, rtol=1e-3, atol=1e-3).mean())
    ma, mb = a.mean(axis=(0, 1)), b.mean(axis=(0, 1))
    print(f"{label}: components close {close:.5f}, mean card {ma}, mean cpu {mb}")
    if close < 0.99 or not np.allclose(ma, mb, rtol=2e-3, atol=0.0):
        raise AssertionError(f"{label}: card render disagrees with the CPU render")


@phase("9 small stress render, card vs CPU")
def small_stress_reference():
    """A 5,986-triangle stress scene, 64x48 at 2 spp and 8 bounces, through
    the traversal kernels and through their plain versions on the CPU."""
    from mcpt_tpu_torch.render.renderer import RenderConfig, Renderer

    imgs = []
    for scene in stress_scene(SMALL_STRESS_TRIS, 0, ("cuda", "cpu")):
        r = Renderer(scene, RenderConfig(max_bounces=8, width=64, height=48, spp_per_pass=2, seed=1))
        r.step()
        imgs.append((r.film.accum / r.film.spp).cpu().numpy())
    _render_contract(f"stress-{SMALL_STRESS_TRIS} 64x48x2spp", *imgs)


@phase("14 small stress render through the select kernels, card vs CPU")
def small_select_reference():
    """Phase 9's render with MCPT_TREELET_SELECT=smem: the select kernels on
    the card, their plain walks on the CPU."""
    from mcpt_tpu_torch.ops import intersect

    intersect.TREELET_SELECT = "smem"
    try:
        small_stress_reference.__wrapped__()
    finally:
        intersect.TREELET_SELECT = "vote"


# With --save-closest-batch PATH, phase 8 saves the rays of the bathroom
# pass's third closest-hit launch there; with --save-batches DIR, phases 3,
# 4, 7, 8, 11 and 12 save their timed batches there (for time_closest_batch.py).
SAVE_CLOSEST_BATCH = None
SAVE_BATCHES = None


def main() -> int:
    import argparse

    import torch

    global SAVE_CLOSEST_BATCH, SAVE_BATCHES
    ap = argparse.ArgumentParser(description="Drive the mcpt_tpu_torch port once on one CUDA card and check it.")
    ap.add_argument("--save-closest-batch", metavar="PATH", help="save phase 8's third closest-hit batch")
    ap.add_argument("--save-batches", metavar="DIR", help="save the timed batches of phases 3, 4, 7, 8, 11 and 12")
    args = ap.parse_args()
    if args.save_closest_batch:
        SAVE_CLOSEST_BATCH = os.path.abspath(args.save_closest_batch)
    if args.save_batches:
        SAVE_BATCHES = os.path.abspath(args.save_batches)
        os.makedirs(SAVE_BATCHES, exist_ok=True)

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
    small_reference(scene)
    del scene
    bath = bathroom_scene()
    trav_kernels, batches, walks = check_traversal(bath)
    kernels += trav_kernels
    (launches8, film8), thirds = bathroom_main_path(bath)
    launches.update({k: v for k, v in launches8.items() if k.startswith(("traverse_", "schedule_"))})
    treelet_layout(bath)
    kernels += check_schedule(bath, batches, walks)
    kernels += check_select(bath, batches, walks, thirds)
    del batches, thirds
    launches.update({k: v for k, v in bathroom_select_path(bath, film8).items() if k.startswith("select_")})
    for k in kernels:
        k["launches"] = launches[k["name"]]
    del bath, film8
    small_stress_reference()
    small_select_reference()
    print(f"total {time.perf_counter() - t_start:.2f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
