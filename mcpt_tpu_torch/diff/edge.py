"""Edge-aware (silhouette) gradients: boundary sampling for NEE visibility.

Port of mcpt_tpu/diff/edge.py. The detached estimator (diff/grad.py)
freezes visibility, so d(pixel)/d(vertex) misses the derivative of a
silhouette sweeping across the light as an occluder moves. This module
estimates that term for first-vertex direct lighting from one
parallelogram light (Li et al. 2018, "Differentiable Monte Carlo Ray
Tracing through Edge Sampling"), by Reynolds transport over the light
surface:

    dI/dtheta = INT_C f(x, y(s)) (dy/dtheta . n_occ(s)) |dy/ds| ds,
    f = brdf(x) * Le * cos_x * cos_y / d^2,

C the projection of the occluders' silhouette edges from the shading
point x onto the light plane, n_occ its in-plane normal into the occluded
region. f carries no MIS weight: NEE and the BSDF strategy split the same
integrand, so one boundary integral covers both. The projection
y(p) = x + c (p - x), c = <q0-x, n_l> / <p-x, n_l>, has the closed-form
Jacobian dy/dp = c (I - (p-x) n_l^T / <p-x, n_l>), so the estimator is
vectorised torch over (pixel, edge, stratified sample): no autograd, no RNG.

Scope, as the reference's: a diffuse first vertex (kd/pi) and one
parallelogram light of constant radiance. With `edge_nf`/`edge_opp`
(build_silhouette_tables) each (shading point, edge sample) passes a
silhouette test and is oriented by its front-facing face's projected
interior; with `scene`, both sight segments x -> p -> y are checked with
the production any_hit, so a boundary in another occluder's shadow adds
nothing. Only the triples whose projection lands inside the light are
traced (the others contribute nothing whatever the answer), which gives
the reference's result with far fewer shadow rays.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from mcpt_tpu_torch.utils.math import cross, dot, normalize

EST_BOUNCES = 2  # bounces of make_nee_edge_term's render of I (mcpt_tpu's default)


def build_silhouette_tables(scene):
    """Edge tables over the scene's shared vertex buffer, built on the host.

    Returns (verts [Nv,3], edges i32[E,2], edge_nf [E,2,3], edge_opp
    i32[E,2]) on the scene's device: each unique mesh edge's shared-vertex
    endpoints, the unit geometric normals of its (up to two) adjacent
    faces (a zero row for a boundary edge) and each face's opposite vertex
    (-1 when missing). Emissive faces are left out: the light's own
    boundary is another derivative term.
    """
    g = scene.geom
    if g.vert_idx is None:
        raise ValueError("scene has no shared-vertex mapping (geom.vert_idx)")
    vi, v0, e1, e2, mat = (x.detach().cpu().numpy() for x in (g.vert_idx, g.v0, g.e1, g.e2, g.mat_id))
    nv = int(vi.max()) + 1
    verts = np.zeros((nv, 3), np.float32)
    corners = np.stack([v0, v0 + e1, v0 + e2], axis=1)  # [T,3,3]
    verts[vi.reshape(-1)] = corners.reshape(-1, 3)
    n_face = np.cross(e1, e2)
    n_face = n_face / np.maximum(np.linalg.norm(n_face, axis=1, keepdims=True), 1e-30)

    emissive = scene.mats.radiance.detach().cpu().numpy().max(axis=1)[mat] > 0

    edge_map = {}
    for t in range(vi.shape[0]):
        if emissive[t]:
            continue
        a, b, c = int(vi[t, 0]), int(vi[t, 1]), int(vi[t, 2])
        for (i, j, opp) in ((a, b, c), (b, c, a), (c, a, b)):
            edge_map.setdefault((min(i, j), max(i, j)), []).append((t, opp))
    E = len(edge_map)
    edges = np.zeros((E, 2), np.int32)
    edge_nf = np.zeros((E, 2, 3), np.float32)
    edge_opp = np.full((E, 2), -1, np.int32)
    for k, (key, faces) in enumerate(sorted(edge_map.items())):
        edges[k] = key
        for f, (t, opp) in enumerate(faces[:2]):
            edge_nf[k, f] = n_face[t]
            edge_opp[k, f] = opp
    dev = scene.device
    return tuple(torch.from_numpy(x).to(dev) for x in (verts, edges, edge_nf, edge_opp))


def _occluded(scene, o, d, t_max, t_lo, where):
    """any_hit on the rows of `where` only; False elsewhere."""
    from mcpt_tpu_torch.ops.intersect import any_hit

    flat = where.reshape(-1)
    idx = torch.nonzero(flat).squeeze(1)
    out = torch.zeros(flat.shape, dtype=torch.bool, device=flat.device)
    if idx.numel():
        out[idx] = any_hit(scene, o.reshape(-1, 3)[idx], d.reshape(-1, 3)[idx], t_min=t_lo,
                           t_max=t_max.reshape(-1)[idx])
    return out.reshape(where.shape)


def nee_visibility_edge_grad(x, n_x, kd, weight, occ_verts, occ_edges, light_q0, light_eu, light_ev, light_le,
                             n_samples: int = 128, edge_nf: Optional[torch.Tensor] = None,
                             edge_opp: Optional[torch.Tensor] = None, scene=None) -> torch.Tensor:
    """d(Loss)/d(occ_verts) [V,3]: the visibility edge term of first-vertex
    direct lighting for a loss with per-pixel adjoint `weight` [R,3].

    x, n_x, kd: [R,3] shading points, normals and diffuse albedo;
    occ_edges i32[E,2] index occ_verts; the light is the parallelogram
    (light_q0, light_eu, light_ev) with radiance light_le. Midpoint samples,
    `n_samples` an edge; a sample whose projection falls outside the light
    adds nothing. `edge_nf` [E,2,3] and `edge_opp` [E,2,3] (opposite-vertex
    positions) turn on the silhouette test and the face orientation
    (otherwise the occluder centroid orients every edge, right for one
    convex occluder only); `scene` turns on the mutual-occlusion tests.
    """
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    light_q0, eu, ev, light_le = (torch.as_tensor(v, **f32) for v in (light_q0, light_eu, light_ev, light_le))
    occ_edges = occ_edges.long()
    S = n_samples

    n_l = normalize(cross(eu, ev))  # light plane normal
    # dual basis of the inside-parallelogram test
    guu, guv, gvv = dot(eu, eu), dot(eu, ev), dot(ev, ev)
    det_g = guu * gvv - guv * guv
    centroid = torch.mean(occ_verts, dim=0)

    va = occ_verts[occ_edges[:, 0]]  # [E,3]
    vb = occ_verts[occ_edges[:, 1]]
    s = (torch.arange(S, **f32) + 0.5) / S  # stratified midpoints
    p = va[:, None, :] + s[None, :, None] * (vb - va)[:, None, :]  # [E,S,3]
    # layout [R,E,S,3]
    xb = x[:, None, None, :]
    d_xp = p[None] - xb
    h = torch.sum(d_xp * n_l, dim=-1)  # <p-x, n_l> [R,E,S]
    A0 = torch.sum((light_q0 - x) * n_l, dim=-1)  # [R]
    A = A0[:, None, None]
    h_ok = torch.abs(h) > 1e-12
    h_safe = torch.where(h_ok, h, 1.0)
    # only edges strictly between x and the light plane cast this boundary
    valid_h = h_ok & (A / torch.where(h == 0, 1.0, h) > 1.0)
    c = torch.where(valid_h, A / h_safe, 0.0)
    y = xb + c[..., None] * d_xp  # projected boundary points

    # inside-parallelogram test in the light's (u, v) coordinates
    rel = y - light_q0
    bu = torch.sum(rel * eu, dim=-1)
    bv = torch.sum(rel * ev, dim=-1)
    au = (gvv * bu - guv * bv) / det_g
    av = (guu * bv - guv * bu) / det_g
    inside = (au >= 0) & (au <= 1) & (av >= 0) & (av <= 1) & valid_h

    if edge_nf is not None:
        # silhouette test: the adjacent faces straddle the view direction
        # (a boundary edge always qualifies)
        s1 = torch.sum(d_xp * edge_nf[None, :, None, 0, :], dim=-1)
        s2 = torch.sum(d_xp * edge_nf[None, :, None, 1, :], dim=-1)
        has2 = (torch.sum(edge_nf[:, 1] ** 2, dim=-1) > 0)[None, :, None]
        inside = inside & torch.where(has2, s1 * s2 < 0, True)

    if scene is not None:
        # mutual occlusion on both segments x -> p and p -> y (collinear);
        # the margins are NEE's 1e-3 shadow-ray backoff, so an edge's own
        # faces never occlude its grazing point
        dist_xp = torch.sqrt(torch.clamp(torch.sum(d_xp * d_xp, dim=-1), min=1e-20))
        w_xp = d_xp / dist_xp[..., None]
        t_lo = 1e-4 * scene.scale
        occ1 = _occluded(scene, xb.expand_as(d_xp), w_xp, dist_xp * (1.0 - 1e-3), t_lo, inside)
        dist_xy = torch.sqrt(torch.clamp(torch.sum((y - xb) ** 2, dim=-1), min=1e-20))
        o2 = xb + w_xp * (dist_xp * (1.0 + 1e-3))[..., None]
        t2 = torch.clamp(dist_xy * (1.0 - 1e-3) - dist_xp * (1.0 + 1e-3), min=0.0)
        occ2 = _occluded(scene, o2, w_xp, t2, t_lo, inside & ~occ1)
        inside = inside & ~occ1 & ~occ2

    # area-form integrand f(x, y), no MIS split
    d_xy = y - xb
    d2 = torch.sum(d_xy * d_xy, dim=-1)
    w_dir = d_xy / torch.sqrt(torch.clamp(d2, min=1e-20))[..., None]
    cos_x = torch.clamp(torch.sum(n_x[:, None, None, :] * w_dir, dim=-1), min=0.0)
    cos_y = torch.clamp(torch.sum(-w_dir * n_l, dim=-1), min=0.0)
    geom = cos_x * cos_y / torch.clamp(d2, min=1e-20)
    f_rgb = (kd[:, None, None, :] / math.pi) * light_le * geom[..., None]

    # curve tangent dy/ds through the Jacobian, and the speed |dy/ds|
    e_dir = (vb - va)[None, :, None, :]
    dy_ds = c[..., None] * (e_dir - d_xp * (torch.sum(e_dir * n_l, dim=-1) / h_safe)[..., None])
    speed = torch.sqrt(torch.clamp(torch.sum(dy_ds * dy_ds, dim=-1), min=1e-30))
    tau = dy_ds / speed[..., None]
    n_curve = cross(n_l.expand_as(tau), tau)  # in the light plane
    if edge_nf is not None and edge_opp is not None:
        # orient toward the occluded side: the front-facing adjacent
        # face's interior projects into the shadow; a boundary edge uses
        # its only face whatever its facing (a sheet occludes both ways)
        s1 = torch.sum(d_xp * edge_nf[None, :, None, 0, :], dim=-1)
        has2 = (torch.sum(edge_nf[:, 1] ** 2, dim=-1) > 0)[None, :, None]
        front1 = torch.where(has2, s1 < 0, True)
        opp = torch.where(front1[..., None], edge_opp[None, :, None, 0, :], edge_opp[None, :, None, 1, :])
        h_o = torch.sum((opp - xb) * n_l, dim=-1)
        c_o = A / torch.where(torch.abs(h_o) > 1e-12, h_o, 1e-12)
        y_o = xb + c_o[..., None] * (opp - xb)
        sign = torch.sign(torch.sum((y_o - y) * n_curve, dim=-1))
    else:
        # orient by the projected occluder centroid
        h_c = torch.sum((centroid - x) * n_l, dim=-1)
        c_c = A0 / torch.where(torch.abs(h_c) > 1e-12, h_c, 1e-12)
        y_c = x + c_c[:, None] * (centroid - x)
        sign = torch.sign(torch.sum((y_c[:, None, None, :] - y) * n_curve, dim=-1))
    n_occ = n_curve * torch.where(sign == 0, 1.0, sign)[..., None]

    w_pix = torch.sum(weight[:, None, None, :] * f_rgb, dim=-1)  # [R,E,S]
    common = torch.where(inside, w_pix * speed, 0.0) / S  # ds = 1/S
    # d<y, n_occ>/dp = (dy/dp)^T n_occ = c (n_occ - n_l <d_xp, n_occ> / h)
    vjp_n = c[..., None] * (n_occ - n_l * (torch.sum(d_xp * n_occ, dim=-1) / h_safe)[..., None])
    contrib = common[..., None] * vjp_n
    ga = torch.sum(contrib * (1.0 - s)[None, None, :, None], dim=(0, 2))  # [E,3]
    gb = torch.sum(contrib * s[None, None, :, None], dim=(0, 2))
    grad = torch.zeros_like(occ_verts)
    grad.index_add_(0, occ_edges[:, 0], ga)
    grad.index_add_(0, occ_edges[:, 1], gb)
    return grad


def make_nee_edge_term(scene, target, light_q0, light_eu, light_ev, light_le, n_samples: int = 64,
                       est_spp: int = 2):
    """An `extra_grad_fn` for run_inverse: the NEE visibility term of
    d(MSE)/d(dverts), in nee_visibility_edge_grad's scope, with silhouette
    tables over the whole scene and mutual occlusion through the production
    any_hit. The MSE adjoint 2 (I - target) / N uses an `est_spp`-sample,
    EST_BOUNCES-bounce render of I at the current parameters.

    Returns fn(params, key) -> SceneParams (zeros for kd, ks, radiance).
    """
    from mcpt_tpu_torch.diff.grad import SceneParams, render_image
    from mcpt_tpu_torch.ops.intersect import closest_hit
    from mcpt_tpu_torch.render.camera import generate_rays
    from mcpt_tpu_torch.render.integrator import make_expander

    verts, edges, edge_nf, edge_opp_id = build_silhouette_tables(scene)
    opp_pos = verts[torch.clamp(edge_opp_id, min=0).long()]
    cam = scene.camera
    n_pix = cam.height * cam.width
    pidx = torch.arange(n_pix, device=scene.device)
    # pixel-centre primary hits (the boundary term is about the light's
    # visibility, so the camera's hit selection stays frozen)
    org, dirn = generate_rays(cam, torch.full((n_pix, 2), 0.5, device=scene.device), pidx)
    hit = closest_hit(scene, org, dirn)
    x = org + torch.where(hit.valid, hit.t, 0.0)[:, None] * dirn
    n_x = make_expander(scene)(hit, org, dirn).normal
    mat_of_pix = scene.geom.mat_id[torch.clamp(hit.tri, min=0).long()].long()
    valid = hit.valid

    def fn(params, key):
        with torch.no_grad():
            img = render_image(params, scene, key, est_spp, EST_BOUNCES)
            adj = 2.0 * (img - target) / (n_pix * 3.0)
            weight = torch.where(valid[:, None], adj.reshape(n_pix, 3), 0.0)
            g = nee_visibility_edge_grad(
                x, n_x, params.kd[mat_of_pix], weight, verts, edges, light_q0=light_q0, light_eu=light_eu,
                light_ev=light_ev, light_le=light_le, n_samples=n_samples, edge_nf=edge_nf,
                edge_opp=opp_pos, scene=scene)
        return SceneParams(kd=torch.zeros_like(params.kd), ks=torch.zeros_like(params.ks),
                           radiance=torch.zeros_like(params.radiance),
                           dverts=None if params.dverts is None else g)

    return fn
