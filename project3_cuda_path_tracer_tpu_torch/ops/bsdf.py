"""BSDF sampling and path scattering: the scatterRay contract, plain PyTorch.

The twin of the JAX package's `ops/bsdf.py`:
- ideal diffuse via the cosine-weighted hemisphere sampler
  (src/interactions.h:10-42),
- perfect specular mirror (glm::reflect), Phong glossy when SPECEX > 0,
- refraction with Snell's law + Schlick Fresnel, TIR reflects,
- probabilistic mixing with probability-division compensation
  (src/interactions.h:55-62),
- subsurface scattering (SSS > 0, diffusion-lite): a cosine lobe around
  the inward normal on entry, Beer-Lambert absorption on exit; it wins
  over the other lobes and draws no number of its own,
- emissive surfaces terminate the path (src/pathtrace.cu:247-249).

Every lane evaluates every branch and `torch.where` selects, so the
lanes' arithmetic is that of the JAX package lane for lane. The CUDA
kernel branches per thread instead; the values are the same.
"""

from __future__ import annotations

import torch

from ..utils.math3d import SQRT_OF_ONE_THIRD, TWO_PI
from .vec import Vec3, where as vwhere

RAY_EPS = 1e-4


def _frame(axis: Vec3):
    """Two unit tangents of `axis` (Peter Kutz's not-the-normal trick,
    src/interactions.h:24-31)."""
    use_x = axis.x.abs() < SQRT_OF_ONE_THIRD
    use_y = (~use_x) & (axis.y.abs() < SQRT_OF_ONE_THIRD)
    not_axis = Vec3(
        use_x.to(torch.float32),
        use_y.to(torch.float32),
        (~(use_x | use_y)).to(torch.float32),
    )
    t1 = axis.cross(not_axis).normalize()
    t2 = axis.cross(t1).normalize()
    return t1, t2


def cosine_hemisphere(normal: Vec3, u1: torch.Tensor, u2: torch.Tensor) -> Vec3:
    """calculateRandomDirectionInHemisphere (src/interactions.h:10-42)."""
    up = torch.sqrt(u1)  # cos(theta)
    over = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))  # sin(theta)
    around = u2 * TWO_PI
    perp1, perp2 = _frame(normal)
    return (
        normal * up
        + perp1 * (torch.cos(around) * over)
        + perp2 * (torch.sin(around) * over)
    )


def reflect(d: Vec3, n: Vec3) -> Vec3:
    """glm::reflect: d - 2*dot(d,n)*n."""
    return d - n * (2.0 * d.dot(n))


def phong_lobe(axis: Vec3, exponent: torch.Tensor, u1, u2) -> Vec3:
    """Sample a power-cosine (Phong) lobe around `axis`:
    cos(theta) = u1^(1/(e+1))."""
    cos_t = u1 ** (1.0 / (exponent + 1.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = u2 * TWO_PI
    t1, t2 = _frame(axis)
    return axis * cos_t + t1 * (torch.cos(phi) * sin_t) + t2 * (
        torch.sin(phi) * sin_t
    )


def refract(d: Vec3, n: Vec3, eta: torch.Tensor):
    """glm::refract + TIR flag. n oriented against d; eta (P,) = n1/n2."""
    cos_i = -d.dot(n)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = k < 0.0
    refr = d * eta + n * (eta * cos_i - torch.sqrt(torch.clamp(k, min=0.0)))
    return refr, tir


def schlick(cos_i: torch.Tensor, ior: torch.Tensor) -> torch.Tensor:
    """Schlick's approximation of Fresnel reflectance."""
    r0 = ((1.0 - ior) / (1.0 + ior)) ** 2
    m = torch.clamp(1.0 - cos_i, 0.0, 1.0)
    return r0 + (1.0 - r0) * m * m * m * m * m


def scatter(
    origins: Vec3,
    dirs: Vec3,
    t: torch.Tensor,  # (P,) intersection distance (world euclidean)
    normal: Vec3,  # oriented world normal
    outside: torch.Tensor,  # (P,) bool
    # gathered material columns:
    m_color: Vec3,
    m_spec_color: Vec3,
    m_has_refl: torch.Tensor,
    m_has_refr: torch.Tensor,
    m_ior: torch.Tensor,
    m_emittance: torch.Tensor,
    m_spec_exp: torch.Tensor | None,  # SPECEX column; None = all perfect
    u_hemi1: torch.Tensor,  # (P,) hemisphere xi_1
    u_hemi2: torch.Tensor,  # (P,) hemisphere xi_2
    u_branch: torch.Tensor | None = None,  # spec/diffuse lottery; None when
    # every material's REFL is 0 or 1
    u_fresnel: torch.Tensor | None = None,  # Fresnel lottery; None when the
    # scene has no refractive material
    m_sss: torch.Tensor | None = None,  # SSS extinction sigma; None = none
    t_segment: torch.Tensor | None = None,  # segment length for absorption
):
    """One shading step for all lanes.

    Returns (new_origins, new_dirs, throughput_multiplier Vec3,
    emitted Vec3, terminate (P,) bool). A draw passed as None removes
    that branch, as the scene-specialised draw layout does."""
    p_hit = origins + dirs * (t - RAY_EPS)  # getPointOnRay semantics

    emissive = m_emittance > 0.0
    refractive = m_has_refr > 0.0
    reflective = m_has_refl > 0.0

    # ---- diffuse branch ----
    diff_dir = cosine_hemisphere(normal, u_hemi1, u_hemi2)

    # ---- mirror branch (Phong-glossy when SPECEX > 0) ----
    spec_dir = reflect(dirs, normal)
    if m_spec_exp is not None:
        glossy = phong_lobe(spec_dir, m_spec_exp, u_hemi1, u_hemi2)
        # keep the mirror ray when the lobe sample dips below the surface
        ok = glossy.dot(normal) > 0.0
        spec_dir = vwhere((m_spec_exp > 0.0) & ok, glossy, spec_dir)

    # ---- reflective/diffuse probabilistic mix ----
    if u_branch is not None:
        p_spec = torch.clamp(m_has_refl, 0.0, 1.0)
        pick_spec = u_branch < p_spec
        inv_p = 1.0 / torch.clamp(p_spec, min=1e-6)
        inv_q = 1.0 / torch.clamp(1.0 - p_spec, min=1e-6)
        mix_dir = vwhere(pick_spec, spec_dir, diff_dir)
        mix_tint = vwhere(pick_spec, m_spec_color * inv_p, m_color * inv_q)
    else:
        # all REFL values are 0 or 1: reflective lanes are pure mirrors
        mix_dir = spec_dir
        mix_tint = m_spec_color

    new_dir = vwhere(reflective, mix_dir, diff_dir)
    tint = vwhere(reflective, mix_tint, m_color)
    new_origin = p_hit

    # ---- refractive branch (Fresnel lottery via Schlick) ----
    if u_fresnel is not None:
        eta = torch.where(outside, 1.0 / torch.clamp(m_ior, min=1e-6), m_ior)
        cos_i = torch.clamp(-dirs.dot(normal), 0.0, 1.0)
        fresnel = schlick(cos_i, torch.clamp(m_ior, min=1.0))
        refr_dir, tir = refract(dirs, normal, eta)
        do_reflect_glass = tir | (u_fresnel < fresnel)
        glass_dir = vwhere(do_reflect_glass, spec_dir, refr_dir.normalize())
        glass_tint = vwhere(do_reflect_glass, m_spec_color, m_color)
        # push refracted rays through the interface; reflected stay outside
        glass_origin = vwhere(
            do_reflect_glass, p_hit, p_hit + glass_dir * (2.0 * RAY_EPS + 1e-3)
        )
        new_dir = vwhere(refractive, glass_dir, new_dir)
        tint = vwhere(refractive, glass_tint, tint)
        new_origin = vwhere(refractive, glass_origin, new_origin)

    # ---- subsurface branch (INSTRUCTION.md:121, diffusion-lite) ----
    # Entry (outside): diffuse transmission, a cosine hemisphere around
    # the inward normal tinted by the surface colour. Exit (inside): the
    # oriented normal points back toward the ray, so -normal is outward,
    # and the same sampling leaves the medium with Beer-Lambert absorption
    # exp(-sigma * the segment's length inside).
    if m_sss is not None:
        sss = m_sss > 0.0
        sss_dir = cosine_hemisphere(-normal, u_hemi1, u_hemi2)
        att = torch.exp(-m_sss * t_segment)
        sss_tint = vwhere(outside, m_color, Vec3(att, att, att))
        sss_origin = p_hit + sss_dir * (2.0 * RAY_EPS + 1e-3)
        new_dir = vwhere(sss, sss_dir, new_dir)
        tint = vwhere(sss, sss_tint, tint)
        new_origin = vwhere(sss, sss_origin, new_origin)

    emitted = m_color * m_emittance
    return new_origin, new_dir.normalize(), tint, emitted, emissive
