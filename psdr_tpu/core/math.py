"""Vectorized geometry / shading math helpers.

All functions operate on arrays whose *last* axis carries vector components
(shape ``(..., 3)`` for 3D vectors) and are fully differentiable unless noted.

Parity reference: psdr-cuda include/psdr/utils.h:31-164 (sign, sphdir,
bilinear, rgb2luminance, ray_intersect_triangle, ray_intersect_box,
ray_intersect_scene_aabb, fresnel).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .constants import Epsilon


def dot(a: jax.Array, b: jax.Array) -> jax.Array:
    """Batched inner product along the last axis, keepdims dropped."""
    return jnp.sum(a * b, axis=-1)


def cross(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.cross(a, b)


def norm(a: jax.Array) -> jax.Array:
    return jnp.sqrt(jnp.sum(a * a, axis=-1))


def squared_norm(a: jax.Array) -> jax.Array:
    return jnp.sum(a * a, axis=-1)


def normalize(a: jax.Array) -> jax.Array:
    # backward-safe at a == 0 EXACTLY: a / max(sqrt(S), eps) still NaNs
    # under reverse-mode there — sqrt's tangent is inf at S=0 and max's
    # zero cotangent gives 0 * inf (hit by the flagship recovery when the deforming mesh folds a triangle to zero
    # area: cross(e1, e2) == 0 exactly). rsqrt(max(S, eps)) has a finite
    # derivative everywhere, so masked/zero cotangents stay zero.
    return a * safe_rsqrt(squared_norm(a))[..., None]


@jax.custom_jvp
def safe_sqrt(x: jax.Array) -> jax.Array:
    return jnp.sqrt(jnp.maximum(x, 0.0))


@safe_sqrt.defjvp
def _safe_sqrt_jvp(primals, tangents):
    # bounded derivative at 0 (plain sqrt has an inf tangent there, which
    # poisons whole wavefronts through jvp even on masked lanes)
    (x,), (t,) = primals, tangents
    y = safe_sqrt(x)
    return y, t * 0.5 / jnp.maximum(y, 1e-6)


def safe_rsqrt(x: jax.Array) -> jax.Array:
    return jax.lax.rsqrt(jnp.maximum(x, 1e-20))


@jax.custom_jvp
def safe_acos(x: jax.Array) -> jax.Array:
    return jnp.arccos(jnp.clip(x, -1.0, 1.0))


@safe_acos.defjvp
def _safe_acos_jvp(primals, tangents):
    # acos'(x) = -1/sqrt(1-x^2) is inf/NaN at the poles (|x| = 1); an
    # envmap evaluated exactly at a lat-long pole otherwise emits NaN
    # tangents into the whole image (bunny_env_2 regression)
    (x,), (t,) = primals, tangents
    y = safe_acos(x)
    denom = jnp.sqrt(jnp.maximum(1.0 - x * x, 1e-8))
    return y, -t / denom


def rcp(x: jax.Array) -> jax.Array:
    return 1.0 / x


def sqr(x: jax.Array) -> jax.Array:
    return x * x


def lerp(a, b, t):
    return a + (b - a) * t


def sign_eps(x: jax.Array, eps: float) -> jax.Array:
    """Ternary sign with a dead zone: +1 if x > eps, -1 if x < -eps, else 0.

    Parity: utils.h:31-38 ``sign<ad>(x, eps)``.
    """
    return jnp.where(x > eps, 1, jnp.where(x < -eps, -1, 0)).astype(jnp.int32)


def sphdir(theta: jax.Array, phi: jax.Array) -> jax.Array:
    """Spherical angles -> unit direction (utils.h:41-46)."""
    st, ct = jnp.sin(theta), jnp.cos(theta)
    sp, cp = jnp.sin(phi), jnp.cos(phi)
    return jnp.stack([cp * st, sp * st, ct], axis=-1)


def bilinear(p0: jax.Array, e1: jax.Array, e2: jax.Array, st: jax.Array) -> jax.Array:
    """p0 + e1*s + e2*t with st shape (..., 2) (utils.h:50-53).

    Works for any vector dimensionality of p0/e1/e2 (2D uv or 3D points).
    """
    return p0 + e1 * st[..., 0:1] + e2 * st[..., 1:2]


def rgb2luminance(rgb: jax.Array) -> jax.Array:
    """Rec.709 luminance (utils.h:62-64)."""
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


def ray_intersect_triangle(p0: jax.Array, e1: jax.Array, e2: jax.Array,
                           ray_o: jax.Array, ray_d: jax.Array):
    """Differentiable Moeller-Trumbore; returns ((u, v), t) without validity
    clipping — mirrors utils.h:67-77 which leaves masking to the caller.
    """
    h = cross(ray_d, e2)
    a = dot(e1, h)
    # guard the degenerate/parallel case so masked-out lanes cannot produce
    # NaN gradients downstream (valid hits have |a| well away from zero)
    a = jnp.where(jnp.abs(a) < 1e-20, 1e-20, a)
    f = 1.0 / a
    s = ray_o - p0
    u = f * dot(s, h)
    q = cross(s, e1)
    v = f * dot(ray_d, q)
    t = f * dot(e2, q)
    return jnp.stack([u, v], axis=-1), t


def ray_intersect_box(ray_o, ray_d, lower, upper):
    """Slab test. Returns (active, mint, maxt) (utils.h:107-125)."""
    inv_d = 1.0 / ray_d
    t1 = (lower - ray_o) * inv_d
    t2 = (upper - ray_o) * inv_d
    t1p = jnp.minimum(t1, t2)
    t2p = jnp.maximum(t1, t2)
    mint = jnp.max(t1p, axis=-1)
    maxt = jnp.min(t2p, axis=-1)
    active = maxt >= mint
    return active, mint, maxt


def ray_intersect_scene_aabb(ray_o, ray_d, lower, upper):
    """Intersect a ray (origin inside) with the scene AABB from within.

    Returns (t, n, G) where n is the inward-facing axis normal of the exit
    face and G = cos / t^2 converts the direction pdf to an area pdf.
    Parity: utils.h:128-145.
    """
    t1 = (lower - ray_o) / ray_d
    t2 = (upper - ray_o) / ray_d
    t2p = jnp.maximum(t1, t2)
    t = jnp.min(t2p, axis=-1)
    idx = jnp.argmin(t2p, axis=-1)
    n = -jnp.sign(ray_d) * jax.nn.one_hot(idx, 3, dtype=ray_d.dtype)
    G = dot(n, -ray_d) / sqr(t)
    return t, n, G


def fresnel_conductor(eta_r: jax.Array, eta_i: jax.Array, cos_theta_i: jax.Array) -> jax.Array:
    """Unpolarized conductor Fresnel with complex IOR eta_r + i*eta_i.

    eta_r/eta_i shape (..., C); cos_theta_i shape (...). Parity: utils.h:149-164.
    """
    c = cos_theta_i[..., None]
    cos2 = sqr(c)
    sin2 = 1.0 - cos2
    sin4 = sqr(sin2)
    temp_1 = sqr(eta_r) - sqr(eta_i) - sin2
    a_2_pb_2 = safe_sqrt(sqr(temp_1) + 4.0 * sqr(eta_i * eta_r))
    a = safe_sqrt(0.5 * (a_2_pb_2 + temp_1))
    term_1 = a_2_pb_2 + cos2
    term_2 = 2.0 * c * a
    r_s = (term_1 - term_2) / (term_1 + term_2)
    term_3 = a_2_pb_2 * cos2 + sin4
    term_4 = term_2 * sin2
    r_p = r_s * (term_3 - term_4) / (term_3 + term_4)
    return 0.5 * (r_s + r_p)


def mis_weight(pdf1: jax.Array, pdf2: jax.Array) -> jax.Array:
    """Power-2 MIS heuristic (src/integrator/direct.cpp:17-21)."""
    w1 = sqr(pdf1)
    w2 = sqr(pdf2)
    return w1 / (w1 + w2)


def scrub_nonfinite(x: jax.Array) -> jax.Array:
    """Replace non-finite entries with zero (integrator.cpp:87,112)."""
    return jnp.where(jnp.isfinite(x), x, 0.0)
