"""Wavefront path integrator in its split form: P = split_trace (one closest
hit + one shadow any-hit) and X = split_shade (the NEE, MIS and RR shell),
driven by the host loop in render/renderer.py.

Port of mcpt_tpu/render/integrator.py (split_state0 / split_trace /
split_shade and the helpers they use), the reference's active estimator
(src/Render.cpp:111-175):
  * a bounce-0 emitter hit adds radiance directly (|radiance| > 1e-4);
  * NEE samples one uniform light point per vertex, weighted by the power
    heuristic against the BSDF mixture pdf; its shadow ray is traced by the
    NEXT P step and resolved at the next X step, before that vertex's
    emission, which keeps the reference's add order;
  * the BSDF step samples one lobe; a front-facing emitter reached by the
    new ray adds MIS-weighted emission (full weight after a mirror bounce);
  * Russian roulette after bounce 3 with q = min(max(beta), 0.95).
Lanes are bound to pixels and regenerate a new sample when they die, so
the RNG (keyed by pixel, sample id and bounce) does not depend on lane
placement and chunking or compaction change no sample. The per-hit table
lookups are plain row indexing.

The fixed-bounce loop `trace_paths` / `trace_image` (one sample a lane,
every lane for up to `max_bounces` bounces) is the estimator the gradients
run through (diff/grad.py). It detaches every sampling decision (uniform
draws, sampled directions and their pdf, lobe picks, RR outcomes,
visibility) and keeps every smooth factor attached (hit points and normals
re-derived from the hit triangle's row, NEE geometry pdfs, MIS weights), so
autograd of a render is the detached-random gradient of mcpt_tpu's
`trace_paths(differentiable=True)`. Both integrators take their shading
math (nee_sample, bsdf_continue, emission_contrib) from the same helpers.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from mcpt_tpu_torch.ops.intersect import Hit, any_hit, closest_hit, dispatch_returns_uv
from mcpt_tpu_torch.render.bsdf import bsdf_fx, bsdf_pdf, bsdf_sample, build_lobes
from mcpt_tpu_torch.render.camera import generate_rays
from mcpt_tpu_torch.render.onb import make_onb, to_local, to_world
from mcpt_tpu_torch.scene import Scene
from mcpt_tpu_torch.utils.math import cross, dot, normalize, power_heuristic
from mcpt_tpu_torch.utils.rng import MAX_TAGS, per_ray_keys, ray_uniforms, sample_uniforms

# Secondary-ray t_min relative to the scene diagonal (the reference's
# absolute t1 = 1e-4 scaled for f32).
RAY_EPS_REL = 1e-4
EMIT_DIRECT_THRESH = 1e-4  # bounce-0 direct add (Render.cpp:121)
RR_START_BOUNCE = 3  # RR applies when bounces > 3 (Render.cpp:164)
RR_CLAMP = 0.95

# Rays per chunk of the fixed-bounce loop (trace_image), and
# trace_image_wavefront's default. The split renderer's chunk is the whole
# image (chunk_rays_for), capped by the memory of ~30 [R]-lane state
# buffers.
DEFAULT_CHUNK_RAYS = 32768
SPLIT_CHUNK_RAYS_MAX = 1 << 21

_U32 = 0xFFFFFFFF


# Packed per-triangle table, one row per triangle:
# v0(0:3) e1(3:6) e2(6:9) vn(9:18) uv(18:24) area(24)
# kd(25:28) ks(28:31) ns(31) radiance(32:35) tex_id(35)
TRI_TABLE_COLS = 36


def pack_tri_table(scene: Scene) -> torch.Tensor:
    g, m = scene.geom, scene.mats
    T = g.v0.shape[0]
    mat = g.mat_id.long()
    return torch.cat([
        g.v0, g.e1, g.e2, g.vn.reshape(T, 9), g.uv.reshape(T, 6), g.area[:, None],
        m.kd[mat], m.ks[mat], m.ns[mat][:, None], m.radiance[mat],
        m.tex_id[mat][:, None].float(),
    ], dim=1)


def pack_light_table(scene: Scene) -> torch.Tensor:
    """Light rows: v0(0:3) e1(3:6) e2(6:9) vn(9:18) radiance(18:21) area(21)."""
    g, m = scene.geom, scene.mats
    lt = scene.light_tris.long()
    L = lt.shape[0]
    return torch.cat([
        g.v0[lt], g.e1[lt], g.e2[lt], g.vn[lt].reshape(L, 9),
        m.radiance[g.mat_id[lt].long()], g.area[lt][:, None],
    ], dim=1)


def pack_shade_table(scene: Scene) -> torch.Tensor:
    """Slim rows when the kernel returns (t, u, v): vn(0:9) uv(9:15)
    area(15) mat_id(16)."""
    g = scene.geom
    T = g.v0.shape[0]
    return torch.cat([g.vn.reshape(T, 9), g.uv.reshape(T, 6), g.area[:, None],
                      g.mat_id[:, None].float()], dim=1)


def pack_mat_table(scene: Scene) -> torch.Tensor:
    """Per-material rows kd(0:3) ks(3:6) ns(6) radiance(7:10) tex_id(10)."""
    m = scene.mats
    return torch.cat([m.kd, m.ks, m.ns[:, None], m.radiance, m.tex_id[:, None].float()], dim=1)


@dataclass(frozen=True)
class HitData:
    """Shading data at a hit (reference hitInfo, Render.h:14-24)."""

    point: torch.Tensor  # [R,3]
    normal: torch.Tensor  # [R,3]
    uv: torch.Tensor  # [R,2]
    front: torch.Tensor  # bool[R]
    area: torch.Tensor  # [R]
    kd: torch.Tensor  # [R,3] (texture not applied)
    ks: torch.Tensor  # [R,3]
    ns: torch.Tensor  # [R]
    radiance: torch.Tensor  # [R,3]
    tex_id: torch.Tensor  # i32[R]
    valid: torch.Tensor  # bool[R]


def expand_hit_uv(shade_table, mat_table, hit: Hit, org, dirn) -> HitData:
    """Hit with kernel-computed (u, v) -> HitData via the slim tables;
    point = org + t*dirn."""
    rows = shade_table[torch.clamp(hit.tri, min=0).long()]
    u = hit.u[:, None]
    v = hit.v[:, None]
    w = 1.0 - u - v
    vn = rows[:, 0:9].reshape(-1, 3, 3)
    uvs = rows[:, 9:15].reshape(-1, 3, 2)
    t_safe = torch.where(hit.valid, hit.t, 0.0)
    point = org + t_safe[:, None] * dirn
    n = normalize(w * vn[:, 0] + u * vn[:, 1] + v * vn[:, 2])
    uv = w * uvs[:, 0] + u * uvs[:, 1] + v * uvs[:, 2]
    mrows = mat_table[rows[:, 16].long()]
    return HitData(point=point, normal=n, uv=uv, front=dot(n, dirn) < 0, area=rows[:, 15],
                   kd=mrows[:, 0:3], ks=mrows[:, 3:6], ns=mrows[:, 6], radiance=mrows[:, 7:10],
                   tex_id=mrows[:, 10].to(torch.int32), valid=hit.valid)


def expand_hit(tri_table, hit: Hit, org, dirn) -> HitData:
    """Hit -> HitData via one packed row; barycentrics are recomputed with
    the Moller-Trumbore algebra (reference Triangle.cpp:66-78)."""
    rows = tri_table[torch.clamp(hit.tri, min=0).long()]
    v0, e1, e2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    hv = cross(dirn, e2)
    det = dot(e1, hv)
    inv = torch.where(torch.abs(det) > 0, 1.0 / torch.where(det != 0, det, 1.0), 0.0)
    s = org - v0
    q = cross(s, e1)
    u = (dot(s, hv) * inv)[:, None]
    v = (dot(dirn, q) * inv)[:, None]
    w = 1.0 - u - v
    vn = rows[:, 9:18].reshape(-1, 3, 3)
    uvs = rows[:, 18:24].reshape(-1, 3, 2)
    point = v0 + u * e1 + v * e2
    n = normalize(w * vn[:, 0] + u * vn[:, 1] + v * vn[:, 2])
    uv = w * uvs[:, 0] + u * uvs[:, 1] + v * uvs[:, 2]
    return HitData(point=point, normal=n, uv=uv, front=dot(n, dirn) < 0, area=rows[:, 24],
                   kd=rows[:, 25:28], ks=rows[:, 28:31], ns=rows[:, 31],
                   radiance=rows[:, 32:35], tex_id=rows[:, 35].to(torch.int32),
                   valid=hit.valid)


def make_expander(scene: Scene, differentiable: bool = False):
    """expand(hit, org, dirn) bound to the tables of this scene's dispatch.

    `differentiable=True` takes the full expansion on every route: the
    kernels' (t, u, v) are not differentiable, so the slim expansion would
    give zero vertex gradients past DENSE_KERNEL_MIN_TRIS; expand_hit
    re-derives them attached from the hit triangle's row at the frozen
    selection (mcpt_tpu/render/integrator.py make_expander).
    """
    if dispatch_returns_uv(scene) and not differentiable:
        shade_table, mat_table = pack_shade_table(scene), pack_mat_table(scene)
        return lambda hit, org, dirn: expand_hit_uv(shade_table, mat_table, hit, org, dirn)
    tri_table = pack_tri_table(scene)
    return lambda hit, org, dirn: expand_hit(tri_table, hit, org, dirn)


def apply_texture(scene: Scene, h: HitData) -> torch.Tensor:
    """Diffuse reflectance with nearest-texel lookup (reference
    Texture::get_color, src/model.cpp:30-41); kd when there are no textures."""
    data = scene.atlas.data
    if data.shape[0] == 1 and data.shape[1] == 1:
        return h.kd
    tid = torch.clamp(h.tex_id, min=0).long()
    wh = scene.atlas.size[tid]
    u = torch.clamp(h.uv[:, 0] - torch.floor(h.uv[:, 0]), 0.0, 0.999)
    v = torch.clamp(h.uv[:, 1] - torch.floor(h.uv[:, 1]), 0.0, 0.999)
    x = (u * wh[:, 0]).long()
    y = (v * wh[:, 1]).long()
    return torch.where((h.tex_id >= 0)[:, None], data[tid, y, x], h.kd)


def sample_light_point(light_table, n_lights: int, u0, u1, u2):
    """Uniform point on a uniformly chosen light triangle (reference
    Render::sample, Triangle.cpp:15-22) -> (point, normal, radiance, area)."""
    idx = torch.clamp((u0 * n_lights).to(torch.int64), max=n_lights - 1)
    rows = light_table[idx]
    flip = u1 + u2 > 1.0
    bu = torch.where(flip, 1.0 - u1, u1)[:, None]
    bv = torch.where(flip, 1.0 - u2, u2)[:, None]
    v0, e1, e2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    vn = rows[:, 9:18].reshape(-1, 3, 3)
    point = v0 + bu * e1 + bv * e2
    nrm = normalize((1.0 - bu - bv) * vn[:, 0] + bu * vn[:, 1] + bv * vn[:, 2])
    return point, nrm, rows[:, 18:21], rows[:, 21]


def nee_sample(light_table, n_lights: int, h: HitData, lobes, onb, wo_local, beta, u):
    """Next-event estimation at the vertices `h` (Render.cpp:124-130): one
    uniform light point, weighted by the power heuristic against the BSDF
    mixture pdf. Returns (wl, dist, pdf_ok, contrib): the direction and
    distance of the shadow ray the caller traces, and the unoccluded
    contribution, to be dropped where pdf_ok is False (the light pdf
    underflows: a light point on the shading point, analytically ~0 but
    0 * inf = NaN at f32).

    The wheres and floors keep the backward finite on dead lanes, where
    d == 0 exactly: sqrt'(0) and a 1e-30 floor (whose square underflows)
    would give 0 * inf = NaN. The primal is the plain formulas' wherever
    |d| >= 1e-15.
    """
    lpoint, lnrm, lrad, larea = sample_light_point(light_table, n_lights, u[:, 0], u[:, 1], u[:, 2])
    d = lpoint - h.point
    dist2 = torch.sum(d * d, dim=-1)
    safe_d = dist2 > 0
    dist = torch.where(safe_d, torch.sqrt(torch.where(safe_d, dist2, 1.0)), 0.0)
    wl = d / torch.clamp(torch.where(safe_d, dist, 1.0), min=1e-15)[:, None]
    cos_l = dot(-wl, lnrm)
    nzl = cos_l != 0.0
    pdf_l = torch.where(nzl, dist2 / torch.where(nzl, cos_l, 1.0) / torch.clamp(larea, min=1e-30), 0.0)
    pdf_l = torch.where(torch.isfinite(pdf_l), pdf_l, 0.0)  # a denormal cos_l
    wl_local = to_local(onb, wl)
    w_mis = power_heuristic(pdf_l / n_lights, bsdf_pdf(lobes, wo_local, wl_local))
    fx = bsdf_fx(lobes, wo_local, wl_local)
    cos_s = torch.abs(dot(h.normal, wl))
    pdf_ok = torch.abs(pdf_l) > 1e-20
    contrib = (w_mis[:, None] * beta * lrad * fx
               * (cos_s / torch.where(pdf_ok, pdf_l, 1.0))[:, None] * n_lights)
    return wl, dist, pdf_ok, contrib


def bsdf_continue(lobes, onb, normal, wo_local, beta, live, u):
    """BSDF sampling (Render.cpp:133-140) on the lanes `live`. Returns
    (wi_world, pdf, is_mirror, cont, beta'): cont is live where the pdf is
    usable (> 1e-24, so a denormal pdf cannot overflow beta), and beta' is
    beta * f * cos / pdf there. The sampled direction and its pdf are
    decisions, detached; f and the cosine stay attached."""
    wi_local, f, pdf, is_mirror = bsdf_sample(lobes, wo_local, u[:, 3], u[:, 4], u[:, 5])
    pdf, wi_local = pdf.detach(), wi_local.detach()
    bsdf_ok = torch.abs(pdf) > 1e-24
    cont = live & bsdf_ok
    wi_world = to_world(onb, wi_local)
    cos_s = torch.abs(dot(normal, wi_world))
    beta = torch.where(cont[:, None], beta * f * (cos_s / torch.where(bsdf_ok, pdf, 1.0))[:, None], beta)
    return wi_world, pdf, is_mirror, cont, beta


def emission_contrib(prev_point, h: HitData, prev_pdf, prev_mirror, beta, n_lights: int):
    """beta x the emission of the vertices `h` reached by BSDF sampling from
    prev_point (Render.cpp:142-162): full weight after a mirror bounce,
    else the power heuristic of the (detached) BSDF pdf against the light
    pdf of the reached point, itself detached. The caller masks the lanes
    that reached a front-facing emitter. Where prev_point == h.point a unit
    vector stands in for the zero one, which keeps normalize's backward
    finite and leaves the primal as it is (the pdf's dist2 is 0 either way)."""
    dl = prev_point - h.point
    dist2l = torch.sum(dl * dl, dim=-1)
    dl_safe = torch.where((dist2l > 0)[:, None], dl, torch.ones_like(dl))
    cos_nl = dot(normalize(dl_safe, eps=1e-30), h.normal)
    nz = cos_nl != 0.0
    light_pdf = torch.where(
        nz, dist2l / torch.where(nz, cos_nl, 1.0) / float(max(n_lights, 1))
        / torch.clamp(h.area, min=1e-30), 0.0)
    w_hit = power_heuristic(prev_pdf, light_pdf.detach())
    return torch.where(prev_mirror[:, None], beta * h.radiance, beta * h.radiance * w_hit[:, None])


def path_tables(scene: Scene):
    """(expand, light_table) of the fixed-bounce loop: make_expander's full
    expansion and the light table. Built once a render, so that under
    autograd the scene's tables are packed, and their gradients sent back
    through the material and vertex gathers, once and not once a chunk."""
    light_table = pack_light_table(scene) if scene.num_lights > 0 else None
    return make_expander(scene, differentiable=True), light_table


def trace_paths(scene: Scene, org, dirn, ray_keys, max_bounces: int, tables):
    """Radiance [R,3] of a batch of camera rays, one sample each.

    Port of mcpt_tpu/render/integrator.py trace_paths(differentiable=True):
    every lane runs all `max_bounces` bounces (the reference's fixed scan)
    and every hit is expanded in full from `tables` (path_tables).
    `ray_keys` is the batch's RNG context (utils.rng.per_ray_keys); bounce
    b draws its 7 uniforms from stream b+1.
    """
    R = org.shape[0]
    t_min = RAY_EPS_REL * scene.scale
    n_lights = scene.num_lights
    expand, light_table = tables

    h = expand(closest_hit(scene, org, dirn, t_min=t_min), org, dirn)
    # bounce-0 direct emission (Render.cpp:121-122)
    emis0 = torch.sqrt(torch.sum(h.radiance * h.radiance, dim=-1)) > EMIT_DIRECT_THRESH
    L = torch.where((h.valid & emis0)[:, None], h.radiance, 0.0)
    beta = torch.ones((R, 3), device=org.device)
    active = h.valid
    dir_c = dirn
    for b in range(max_bounces):
        u = ray_uniforms(ray_keys, b + 1, 7)
        lobes = build_lobes(apply_texture(scene, h), h.ks, h.ns)
        onb = make_onb(h.normal)
        wo_local = to_local(onb, -dir_c)

        if n_lights > 0:
            wl, dist, pdf_ok, contrib = nee_sample(light_table, n_lights, h, lobes, onb, wo_local, beta, u)
            # the backed-off bound keeps the light from occluding itself
            occluded = any_hit(scene, h.point, wl, t_min=t_min, t_max=dist * (1.0 - 1e-3))
            L = L + torch.where((active & pdf_ok & ~occluded)[:, None], contrib, 0.0)

        wi_world, pdf, is_mirror, active, beta = bsdf_continue(lobes, onb, h.normal, wo_local, beta, active, u)

        # look-ahead trace (Render.cpp:142-162)
        o_next = h.point.detach()
        hn = expand(closest_hit(scene, o_next, wi_world, t_min=t_min), o_next, wi_world)
        emis_n = torch.sqrt(torch.sum(hn.radiance * hn.radiance, dim=-1)) > 0.0
        hit_light = active & hn.valid & emis_n & hn.front
        L = L + torch.where(hit_light[:, None],
                            emission_contrib(h.point, hn, pdf, is_mirror, beta, n_lights), 0.0)
        active = active & hn.valid

        # Russian roulette (Render.cpp:164-170)
        if b > RR_START_BOUNCE:
            q = torch.clamp(torch.amax(beta, dim=-1), max=RR_CLAMP).detach()
            killed = active & (u[:, 6] > q)
            survived = active & ~killed
            beta = torch.where(survived[:, None], beta / torch.clamp(q, min=1e-30)[:, None], beta)
            active = active & ~killed
        dir_c, h = wi_world, hn
    return L


def trace_image(scene: Scene, cam, sample_key, pixel_idx, max_bounces: int, tables,
                chunk_rays: int = DEFAULT_CHUNK_RAYS):
    """One sample for each of `pixel_idx`'s pixels, in chunks of `chunk_rays`
    rays: radiance [R,3], differentiable in the scene's tables
    (`tables` = path_tables(scene)).

    `sample_key` is a (hi, lo) threefry key; the streams are keyed by global
    pixel id, so the chunking changes no sample.
    """
    R = pixel_idx.shape[0]
    chunk = max(1, min(chunk_rays, R))
    rads = []
    for c0 in range(0, R, chunk):
        pidx = pixel_idx[c0:c0 + chunk]
        ray_keys = per_ray_keys(sample_key, pidx)
        org, dirn = generate_rays(cam, ray_uniforms(ray_keys, 0, 2), pidx)
        rads.append(trace_paths(scene, org, dirn, ray_keys, max_bounces, tables))
    return torch.cat(rads)


def trace_wavefront(scene: Scene, cam, key, pixel_idx, start_idx: int, spp: int, max_bounces: int,
                    lane_valid=None):
    """`spp` samples (ids start_idx, start_idx+1, ...) for each lane's pixel
    of `pixel_idx`, one wavefront of lanes: (L_sum [R,3], traced rays,
    NaN components scrubbed, iterations), the last three 0-d tensors.
    Lanes where `lane_valid` is False start with their samples done.

    mcpt_tpu's loop-mode trace_wavefront (one XLA while loop) has the same
    signature and returns; the port runs the split iteration it is bitwise
    equal to (render/renderer.trace_chunk_split), the one integrator here.
    """
    from mcpt_tpu_torch.render.renderer import trace_chunk_split

    if cam is not scene.camera:
        scene = dataclasses.replace(scene, camera=cam)
    return trace_chunk_split(scene, pixel_idx.long(), lane_valid, key, int(start_idx), max_bounces, spp)


def trace_image_wavefront(scene: Scene, cam, key, pixel_idx, start_idx: int, spp: int, max_bounces: int,
                          chunk_rays: int = DEFAULT_CHUNK_RAYS):
    """trace_wavefront over `pixel_idx` in chunks of `chunk_rays` lanes
    (the last chunk padded with finished lanes): (L_sum [R,3], traced rays,
    NaN components scrubbed), the counts 0-d tensors. The RNG is keyed by
    (pixel, global sample id), so the chunking changes no sample; unlike
    mcpt_tpu's, a chunk is not cut to R lanes, so a renderer that gives a
    part of an image the whole image's chunk size traces its pixels in the
    same number of lanes as the whole image's pass."""
    R = pixel_idx.shape[0]
    dev = pixel_idx.device
    chunk = max(1, chunk_rays)
    n_chunks = max(1, -(-R // chunk))
    Rp = n_chunks * chunk
    pidx = torch.cat([pixel_idx.long(), torch.zeros(Rp - R, dtype=torch.int64, device=dev)])
    lane_valid = torch.arange(Rp, device=dev) < R
    parts = []
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    nan_ct = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        L, nr, nc, _ = trace_wavefront(scene, cam, key, pidx[sl], start_idx, spp, max_bounces,
                                       lane_valid=None if Rp == R else lane_valid[sl])
        parts.append(L)
        nrays = nrays + nr
        nan_ct = nan_ct + nc
    return torch.cat(parts)[:R], nrays, nan_ct


def chunk_rays_for(scene) -> int:
    """Lanes per wavefront chunk: the whole image, capped by memory. (mcpt_tpu
    pads a smaller image to DEFAULT_CHUNK_RAYS lanes, a fixed shape for XLA;
    here padding lanes only cost time, most of all on the CPU.)"""
    cam = scene.camera
    return min(max(cam.width * cam.height, 1), SPLIT_CHUNK_RAYS_MAX)


def split_state0(R: int, spp: int, lane_valid=None, *, device) -> dict:
    """Initial wavefront state: every lane dead, nothing pending. Padding
    lanes (lane_valid False) start with all their samples done."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    s = z(R, dtype=torch.int32)
    if lane_valid is not None:
        s = torch.where(lane_valid, s, spp).to(torch.int32)
    return {
        "s": s,
        "sid": z(R, dtype=torch.int64),  # uint32 values
        "b": z(R, dtype=torch.int32),
        "o": torch.full((R, 3), 1e30, device=device),
        "d": torch.ones((R, 3), device=device),
        "so": torch.full((R, 3), 1e30, device=device),  # pending shadow ray
        "sd": torch.ones((R, 3), device=device),
        "smax": z(R),
        "prev_pdf": z(R),
        "prev_mirror": z(R, dtype=torch.bool),
        "rr_boost": torch.ones((R,), device=device),
        "last_leg": z(R, dtype=torch.bool),
        "pend_ok": z(R, dtype=torch.bool),
        "pend_contrib": z(R, 3),
        "L_path": z(R, 3),
        "L_sum": z(R, 3),
        "beta": torch.ones((R, 3), device=device),
        "alive": z(R, dtype=torch.bool),
        "tracing": z(R, dtype=torch.bool),
        "nrays": z(dtype=torch.int64),
        "nan_ct": z(dtype=torch.int64),
        "iters": z(dtype=torch.int64),
    }


def split_trace(scene: Scene, o, d, so, sd, smax):
    """Program P: one closest hit and one shadow any-hit.

    Returns (hit_t, hit_tri, hit_u, hit_v, occl); u/v are zeros when the
    dispatch path does not compute them.
    """
    t_min = RAY_EPS_REL * scene.scale
    hit = closest_hit(scene, o, d, t_min=t_min)
    occ = any_hit(scene, so, sd, t_min=t_min, t_max=smax)
    u = hit.u if hit.u is not None else torch.zeros_like(hit.t)
    v = hit.v if hit.v is not None else torch.zeros_like(hit.t)
    return hit.t, hit.tri, u, v, occ


def split_shade(scene: Scene, st: dict, hit_t, hit_tri, hit_u, hit_v, occl, key,
                pixel_idx, start_idx: int, spp: int, max_bounces: int):
    """Program X: the integrator shell for one wavefront iteration.

    Same math, RNG draws and add order as mcpt_tpu's split_shade. `key` is
    a (hi, lo) threefry key (utils.rng.prng_key). Returns (st', n_pending),
    n_pending a 0-d tensor; 0 means the chunk is finished.
    """
    if max_bounces + 1 >= MAX_TAGS:
        raise ValueError(f"max_bounces must be < {MAX_TAGS - 1}")
    R = pixel_idx.shape[0]
    dev = pixel_idx.device
    n_lights = scene.num_lights
    expand = make_expander(scene)

    s, sid, b = st["s"], st["sid"], st["b"]
    o, d = st["o"], st["d"]
    prev_pdf, prev_mirror = st["prev_pdf"], st["prev_mirror"]
    rr_boost, last_leg = st["rr_boost"], st["last_leg"]
    L_path, L_sum, beta = st["L_path"], st["L_sum"], st["beta"]
    alive, tracing = st["alive"], st["tracing"]
    nrays, nan_ct = st["nrays"], st["nan_ct"]

    # resolve the previous vertex's NEE with its occlusion answer
    L_path = L_path + torch.where((st["pend_ok"] & ~occl)[:, None], st["pend_contrib"], 0.0)

    if dispatch_returns_uv(scene):
        hit = Hit(t=hit_t, tri=hit_tri, u=hit_u, v=hit_v)
    else:
        hit = Hit(t=hit_t, tri=hit_tri)
    h = expand(hit, o, d)
    valid = tracing & h.valid

    # emission at the reached vertex
    emis_norm = torch.sqrt(torch.sum(h.radiance * h.radiance, dim=-1))
    b0 = b == 0
    L_path = L_path + torch.where((valid & b0 & (emis_norm > EMIT_DIRECT_THRESH))[:, None],
                                  h.radiance, 0.0)
    hit_light = valid & ~b0 & (emis_norm > 0.0) & h.front
    emit_contrib = emission_contrib(o, h, prev_pdf, prev_mirror, beta, n_lights)
    L_path = L_path + torch.where(hit_light[:, None], emit_contrib, 0.0)

    beta = beta * rr_boost[:, None]
    rr_boost = torch.ones((R,), device=dev)

    # vertex shading
    at_vertex = valid & ~last_leg
    u = sample_uniforms(key, pixel_idx, sid, (b + 1).to(torch.int64), 7)
    kd_tex = apply_texture(scene, h)
    lobes = build_lobes(kd_tex, h.ks, h.ns)
    onb = make_onb(h.normal)
    wo_local = to_local(onb, -d)

    # NEE: this vertex's shadow ray and contribution, resolved next step
    if n_lights > 0:
        wl, dist, pdf_ok, contrib = nee_sample(pack_light_table(scene), n_lights, h, lobes, onb, wo_local,
                                               beta, u)
        pend_ok = at_vertex & pdf_ok
        pend_contrib = torch.where(pend_ok[:, None], contrib, 0.0)
        so, sd = h.point, wl
        smax = torch.where(at_vertex, dist * (1.0 - 1e-3), 0.0)
        nrays = nrays + at_vertex.sum()
    else:
        pend_ok = torch.zeros((R,), dtype=torch.bool, device=dev)
        pend_contrib = torch.zeros((R, 3), device=dev)
        so = torch.full((R, 3), 1e30, device=dev)
        sd = torch.ones((R, 3), device=dev)
        smax = torch.zeros((R,), device=dev)

    # BSDF sampling and Russian roulette
    wi_world, pdf, is_mirror, cont, beta = bsdf_continue(lobes, onb, h.normal, wo_local, beta, at_vertex, u)

    q = torch.clamp(torch.amax(beta, dim=-1), max=RR_CLAMP)
    do_rr = (b > RR_START_BOUNCE) & cont
    killed = do_rr & (u[:, 6] > q)
    survived = do_rr & ~killed
    rr_boost = torch.where(survived, 1.0 / torch.clamp(q, min=1e-30), 1.0)
    last_leg = killed | (b >= max_bounces - 1)

    o = torch.where(cont[:, None], h.point, o)
    d = torch.where(cont[:, None], wi_world, d)
    prev_pdf = torch.where(cont, pdf, prev_pdf)
    prev_mirror = torch.where(cont, is_mirror, prev_mirror)
    b = torch.where(cont, b + 1, b)

    # flush; a lane with a pending NEE but no continuation stays alive one
    # more step (not tracing) and flushes after its NEE lands
    alive_next = cont | pend_ok
    flushed = alive & ~alive_next
    nan_mask = torch.isnan(L_path) & flushed[:, None]
    nan_ct = nan_ct + nan_mask.sum()
    L_clean = torch.where(nan_mask, 0.0, L_path)
    L_sum = L_sum + torch.where(flushed[:, None], L_clean, 0.0)
    alive = alive_next
    tracing = cont

    # regenerate dead lanes for the next trace
    start_new = (~alive) & (s < spp)
    sid_new = (start_idx + s.to(torch.int64)) & _U32
    jit2 = sample_uniforms(key, pixel_idx, sid_new, 0, 2)
    o_new, d_new = generate_rays(scene.camera, jit2, pixel_idx)
    sn = start_new[:, None]
    o = torch.where(sn, o_new, o)
    d = torch.where(sn, d_new, d)
    sid = torch.where(start_new, sid_new, sid)
    b = torch.where(start_new, 0, b)
    beta = torch.where(sn, 1.0, beta)
    L_path = torch.where(sn, 0.0, L_path)
    prev_pdf = torch.where(start_new, 0.0, prev_pdf)
    prev_mirror = prev_mirror & ~start_new
    rr_boost = torch.where(start_new, 1.0, rr_boost)
    last_leg = last_leg & ~start_new
    s = torch.where(start_new, s + 1, s)
    alive = alive | start_new
    tracing = tracing | start_new

    # park lanes that trace nothing far outside every box
    o = torch.where(tracing[:, None], o, 1e30)
    d = torch.where(tracing[:, None], d, 1.0)
    nrays = nrays + tracing.sum()

    st2 = {
        "s": s, "sid": sid, "b": b, "o": o, "d": d, "so": so, "sd": sd, "smax": smax,
        "prev_pdf": prev_pdf, "prev_mirror": prev_mirror, "rr_boost": rr_boost,
        "last_leg": last_leg, "pend_ok": pend_ok, "pend_contrib": pend_contrib,
        "L_path": L_path, "L_sum": L_sum, "beta": beta, "alive": alive, "tracing": tracing,
        "nrays": nrays, "nan_ct": nan_ct, "iters": st["iters"] + 1,
    }
    n_pending = (alive | (s < spp)).sum()
    return st2, n_pending
