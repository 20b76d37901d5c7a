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
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from mcpt_tpu_torch.ops.intersect import Hit, any_hit, closest_hit, dispatch_returns_uv
from mcpt_tpu_torch.render.bsdf import bsdf_fx, bsdf_pdf, bsdf_sample, build_lobes
from mcpt_tpu_torch.render.camera import generate_rays
from mcpt_tpu_torch.render.onb import make_onb, to_local, to_world
from mcpt_tpu_torch.scene import Scene
from mcpt_tpu_torch.utils.math import cross, dot, normalize, power_heuristic
from mcpt_tpu_torch.utils.rng import MAX_TAGS, sample_uniforms

# Secondary-ray t_min relative to the scene diagonal (the reference's
# absolute t1 = 1e-4 scaled for f32).
RAY_EPS_REL = 1e-4
EMIT_DIRECT_THRESH = 1e-4  # bounce-0 direct add (Render.cpp:121)
RR_START_BOUNCE = 3  # RR applies when bounces > 3 (Render.cpp:164)
RR_CLAMP = 0.95

# Lanes per wavefront chunk: the whole image in one chunk, capped by the
# memory of ~30 [R]-lane state buffers.
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


def make_expander(scene: Scene):
    """expand(hit, org, dirn) bound to the tables of this scene's dispatch."""
    if dispatch_returns_uv(scene):
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


def chunk_rays_for(scene) -> int:
    """Lanes per wavefront chunk: the whole image, capped by memory."""
    cam = scene.camera
    return min(max(cam.width * cam.height, DEFAULT_CHUNK_RAYS), SPLIT_CHUNK_RAYS_MAX)


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
    dl = o - h.point
    dist2l = torch.sum(dl * dl, dim=-1)
    cos_nl = dot(normalize(dl, eps=1e-30), h.normal)
    nz = cos_nl != 0.0
    light_pdf = torch.where(
        nz,
        dist2l / torch.where(nz, cos_nl, 1.0) / max(float(max(n_lights, 1)), 1.0)
        / torch.clamp(h.area, min=1e-30),
        0.0,
    )
    w_hit = power_heuristic(prev_pdf, light_pdf)
    hit_light = valid & ~b0 & (emis_norm > 0.0) & h.front
    emit_contrib = torch.where(prev_mirror[:, None], beta * h.radiance,
                               beta * h.radiance * w_hit[:, None])
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
        light_table = pack_light_table(scene)
        lpoint, lnrm, lrad, larea = sample_light_point(light_table, n_lights,
                                                       u[:, 0], u[:, 1], u[:, 2])
        dnee = lpoint - h.point
        dist2 = torch.sum(dnee * dnee, dim=-1)
        dist = torch.sqrt(dist2)
        wl = dnee / torch.clamp(dist, min=1e-30)[:, None]
        cos_l = dot(-wl, lnrm)
        nzl = cos_l != 0.0
        pdf_l = torch.where(
            nzl, dist2 / torch.where(nzl, cos_l, 1.0) / torch.clamp(larea, min=1e-30), 0.0)
        pdf_l = torch.where(torch.isfinite(pdf_l), pdf_l, 0.0)
        wl_local = to_local(onb, wl)
        bp = bsdf_pdf(lobes, wo_local, wl_local)
        w_mis = power_heuristic(pdf_l / n_lights, bp)
        fx = bsdf_fx(lobes, wo_local, wl_local)
        cos_s = torch.abs(dot(h.normal, wl))
        pdf_ok = torch.abs(pdf_l) > 1e-20
        contrib = (w_mis[:, None] * beta * lrad * fx
                   * (cos_s / torch.where(pdf_ok, pdf_l, 1.0))[:, None] * n_lights)
        pend_ok = at_vertex & pdf_ok
        pend_contrib = torch.where(pend_ok[:, None], contrib, 0.0)
        so = h.point
        sd = wl
        smax = torch.where(at_vertex, dist * (1.0 - 1e-3), 0.0)
        nrays = nrays + at_vertex.sum()
    else:
        pend_ok = torch.zeros((R,), dtype=torch.bool, device=dev)
        pend_contrib = torch.zeros((R, 3), device=dev)
        so = torch.full((R, 3), 1e30, device=dev)
        sd = torch.ones((R, 3), device=dev)
        smax = torch.zeros((R,), device=dev)

    # BSDF sampling and Russian roulette
    wi_local, f, pdf, is_mirror = bsdf_sample(lobes, wo_local, u[:, 3], u[:, 4], u[:, 5])
    bsdf_ok = torch.abs(pdf) > 1e-24
    wi_world = to_world(onb, wi_local)
    cos_s2 = torch.abs(dot(h.normal, wi_world))
    beta_new = beta * f * (cos_s2 / torch.where(bsdf_ok, pdf, 1.0))[:, None]
    cont = at_vertex & bsdf_ok
    beta = torch.where(cont[:, None], beta_new, beta)

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
