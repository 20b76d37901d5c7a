"""Branchless batched BSDF: Lambert + Blinn-Phong + perfect mirror.

Port of mcpt_tpu/render/bsdf.py (reference src/BSDF.cpp): every lane
evaluates all lobes under masks. Lobe weights are Rec.709 luminance
fractions taken before the energy-conservation rescale; Diffuse Fx has no
backface check; the mirror lobe is a delta with Fx = Pdf = 0 for MIS.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from mcpt_tpu_torch.utils.math import PI, dot, luminance, normalize

MIRROR_NS_THRESHOLD = 10000.0  # reference BSDF.cpp:98


@dataclass(frozen=True)
class Lobes:
    """Per-lane lobe parameters after weighting and energy conservation."""

    kd: torch.Tensor  # f32[R,3]
    ks: torch.Tensor  # f32[R,3]
    ns: torch.Tensor  # f32[R]
    has_spec: torch.Tensor  # bool[R]
    is_mirror: torch.Tensor  # bool[R]
    w_d: torch.Tensor  # f32[R]
    w_s: torch.Tensor  # f32[R]



def build_lobes(kd_tex: torch.Tensor, ks: torch.Tensor, ns: torch.Tensor) -> Lobes:
    """Per-lane lobe set (reference BSDF::BSDF, BSDF.cpp:87-110)."""
    has_spec = torch.sqrt(torch.sum(ks * ks, dim=-1)) > 0.0
    is_mirror = has_spec & (ns >= MIRROR_NS_THRESHOLD)
    spec_reflect = torch.where(is_mirror[:, None], torch.ones_like(ks), ks)

    lum_d = luminance(kd_tex)
    lum_s = torch.where(has_spec, luminance(spec_reflect), 0.0)
    lsum = lum_d + lum_s
    safe = lsum > 0
    den = torch.where(safe, lsum, 1.0)
    w_d = torch.where(safe, lum_d / den, 1.0)
    w_s = torch.where(safe, lum_s / den, 0.0)

    total = kd_tex + torch.where(has_spec[:, None], spec_reflect, 0.0)
    maxc = torch.max(total, dim=-1).values
    scale = torch.where(maxc >= 1.0, 1.0 / torch.clamp(maxc, min=1e-30), 1.0)[:, None]
    return Lobes(kd=kd_tex * scale, ks=spec_reflect * scale, ns=ns,
                 has_spec=has_spec, is_mirror=is_mirror, w_d=w_d, w_s=w_s)


def _safe_pow(base, exp):
    """pow with base >= 0 and 0^0 = 1, as std::pow."""
    safe = base > 0
    b = torch.clamp(torch.where(safe, base, 1.0), min=1.2e-38)
    return torch.where(safe, torch.exp(exp * torch.log(b)), torch.where(exp == 0, 1.0, 0.0))


def _glossy_active(lobes: Lobes, wo, wi):
    return lobes.has_spec & ~lobes.is_mirror & ~((wi[..., 2] < 0) | (wo[..., 2] < 0))


def glossy_fx(lobes: Lobes, wo, wi):
    """[R,3] Blinn-Phong Fx (BSDF.cpp:33-40); zero where the lobe is absent."""
    h = normalize(wi + wo, eps=1e-30)
    hz = torch.clamp(h[..., 2], min=0.0)
    factor = (lobes.ns + 2.0) / (2.0 * PI)
    val = lobes.ks * (factor * _safe_pow(hz, lobes.ns))[:, None]
    return torch.where(_glossy_active(lobes, wo, wi)[:, None], val, 0.0)


def glossy_pdf(lobes: Lobes, wo, wi):
    """[R] Blinn-Phong half-vector pdf (BSDF.cpp:67-76)."""
    h = normalize(wi + wo, eps=1e-30)
    hz = torch.clamp(h[..., 2], min=0.0)
    val = (lobes.ns + 1.0) / (2.0 * PI) * _safe_pow(hz, lobes.ns)
    return torch.where(_glossy_active(lobes, wo, wi), val, 0.0)


def diffuse_fx(lobes: Lobes):
    """[R,3] Lambert Fx = kd/pi, with no backface check (BSDF.cpp:4-9)."""
    return lobes.kd / PI


def diffuse_pdf(wo, wi):
    """[R] cosine pdf with the reference's sign cutoffs (BSDF.cpp:28-31)."""
    bad = (wi[..., 2] < 0) | (wo[..., 2] < 0)
    return torch.where(bad, 0.0, wi[..., 2] / PI)


def bsdf_fx(lobes: Lobes, wo, wi):
    """Sum of lobe Fx in the local frame (reference BSDF::Fx)."""
    return diffuse_fx(lobes) + glossy_fx(lobes, wo, wi)


def bsdf_pdf(lobes: Lobes, wo, wi):
    """Weighted sum of lobe pdfs (reference BSDF::Pdf, BSDF.cpp:153-163)."""
    return diffuse_pdf(wo, wi) * lobes.w_d + glossy_pdf(lobes, wo, wi) * lobes.w_s


def bsdf_sample(lobes: Lobes, wo, u_lobe, u1, u2):
    """One-sample lobe-mixture sampling (reference BSDF::Sample).

    Returns (wi [R,3], f [R,3], pdf [R], is_mirror_sample bool[R]); zero or
    invalid where pdf == 0.
    """
    wo_z = wo[..., 2]
    valid_view = wo_z >= 0

    total_w = torch.where(lobes.has_spec, lobes.w_s + lobes.w_d, lobes.w_d)
    choose_spec = lobes.has_spec & (u_lobe * total_w <= lobes.w_s)

    # diffuse candidate: theta = 0.5*acos(1-2u) (BSDF.cpp:16-23)
    phi_d = u1 * (2.0 * PI)
    theta = 0.5 * torch.arccos(torch.clamp(1.0 - 2.0 * u2, -1.0, 1.0))
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    wi_d = torch.stack([sin_t * torch.cos(phi_d), sin_t * torch.sin(phi_d), cos_t], dim=-1)
    pdf_d = torch.abs(cos_t) / PI
    f_d = diffuse_fx(lobes)

    # glossy candidate: half-vector sampling (BSDF.cpp:42-65)
    phi_s = u1 * (2.0 * PI)
    cos_th = _safe_pow(u2, 1.0 / (lobes.ns + 1.0))
    sin_th = torch.sqrt(torch.clamp(1.0 - cos_th * cos_th, min=0.0))
    h = torch.stack([sin_th * torch.cos(phi_s), sin_th * torch.sin(phi_s), cos_th], dim=-1)
    wi_g = -wo + h * (2.0 * dot(h, wo))[:, None]
    glossy_ok = wi_g[..., 2] >= 0
    pdf_g = torch.where(glossy_ok, (lobes.ns + 1.0) / (2.0 * PI) * _safe_pow(cos_th, lobes.ns), 0.0)
    f_g = glossy_fx(lobes, wo, wi_g)

    # mirror candidate (BSDF.cpp:78-85)
    wi_m = torch.stack([-wo[..., 0], -wo[..., 1], wo_z], dim=-1)
    f_m = torch.where(valid_view[:, None],
                 1.0 / torch.clamp(wo_z, min=1e-15)[:, None] * torch.ones_like(wo), 0.0)
    pdf_m = torch.where(valid_view, 1.0, 0.0)

    pick_mirror = choose_spec & lobes.is_mirror
    pick_glossy = choose_spec & ~lobes.is_mirror
    wi = torch.where(pick_mirror[:, None], wi_m, torch.where(pick_glossy[:, None], wi_g, wi_d))
    chosen_f = torch.where(pick_mirror[:, None], f_m,
                           torch.where(pick_glossy[:, None], f_g, f_d))
    chosen_pdf = torch.where(pick_mirror, pdf_m, torch.where(pick_glossy, pdf_g, pdf_d))
    chosen_w = torch.where(choose_spec, lobes.w_s, lobes.w_d)

    chosen_valid = valid_view & torch.where(pick_glossy, glossy_ok, torch.ones_like(glossy_ok))
    chosen_pdf = torch.where(chosen_valid, chosen_pdf, 0.0)
    chosen_f = torch.where(chosen_valid[:, None], chosen_f, 0.0)
    wi = torch.where(chosen_valid[:, None], wi, 0.0)

    # one-sample MIS mixture: add the other lobes' Fx / weighted Pdf
    # (BSDF.cpp:138-148); the mirror's Fx/Pdf are 0
    other_f_for_spec = diffuse_fx(lobes)
    other_pdf_for_spec = diffuse_pdf(wo, wi) * lobes.w_d
    other_f_for_diff = glossy_fx(lobes, wo, wi)
    other_pdf_for_diff = glossy_pdf(lobes, wo, wi) * lobes.w_s

    f = torch.where(choose_spec[:, None], chosen_f + other_f_for_spec,
                    chosen_f + other_f_for_diff)
    pdf = torch.where(choose_spec, chosen_pdf * chosen_w + other_pdf_for_spec,
                      chosen_pdf * chosen_w + other_pdf_for_diff)
    return wi, f, pdf, pick_mirror & chosen_valid
