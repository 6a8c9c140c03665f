"""Lat-long environment-map emitter with grid importance sampling.

Parity reference: psdr-cuda src/emitter/envmap.cpp —
* configure builds a 2D hypercube distribution over a (2(W-1), 2(H-1)) grid
  with sin-theta weighting (envmap.cpp:10-26);
* eval_direction maps a world direction to lat-long uv (envmap.cpp:41-58);
* position sampling converts a sampled direction into a pseudo area sample
  on the scene AABB with a G-converted pdf (envmap.cpp:71-95);
The scene adds an 8-vertex/12-face bounding mesh carrying this emitter
(scene.cpp:134-180) so env hits look like surface hits.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.constants import Epsilon, InvPi, InvTwoPi, Pi, TwoPi
from ..core.bitmap import Bitmap, eval_bitmap, from_array
from ..core.distribution import (AliasTable, Discrete, Hier2D, HyperCube,
                                 alias_table_host, hier2d_host,
                                 hypercube_init, hypercube_pdf,
                                 hypercube_sample_reuse)
from ..core.math import (dot, normalize, rgb2luminance, safe_acos, safe_rsqrt,
                         safe_sqrt, sphdir, sqr, squared_norm,
                         ray_intersect_scene_aabb)
from ..core import transform as xform
from ..core.records import PositionSample


class EnvironmentMap:
    kind = "env"

    def __init__(self, radiance, scale=1.0, to_world=None, emitter_id: str = ""):
        if not isinstance(radiance, Bitmap):
            radiance = from_array(radiance)
        self.radiance = radiance
        import numpy as _np
        self.scale = _np.float32(scale)
        self.to_world = (_np.eye(4, dtype=_np.float32) if to_world is None
                         else _np.asarray(to_world, _np.float32))

    def params(self) -> dict:
        return {"radiance": self.radiance.data, "scale": self.scale,
                "to_world": self.to_world}

    def set_params(self, p: dict) -> None:
        self.radiance = Bitmap(p["radiance"])
        self.scale = p["scale"]
        self.to_world = p["to_world"]

    def __repr__(self):
        return "EnvironmentMap"


class EnvmapState(NamedTuple):
    """Differentiable runtime state built by the scene (envmap.cpp:10-26)."""
    data: jax.Array        # (H, W, 3)
    scale: jax.Array
    to_world: jax.Array    # (4, 4)
    from_world: jax.Array  # (4, 4)
    cell_distrb: HyperCube
    lower: jax.Array       # scene AABB (3,)
    upper: jax.Array


def _host_mass_grid(radiance, gw, gh, gw_f, gh_f):
    """Numpy mirror of the in-jit mass build (bilinear fine-grid taps with
    sin-theta weighting, max-pooled into the coarse grid when divided).
    Runs at TRACE time from the host Scene's radiance snapshot, so the
    per-frame render program carries the finished table as a constvar
    instead of rebuilding the distribution every frame."""
    import numpy as np
    h, w, _ = radiance.shape
    lum = (radiance[..., 0] * 0.2126 + radiance[..., 1] * 0.7152
           + radiance[..., 2] * 0.0722).astype(np.float64)
    # fine-grid cell centers, bilinear like core/bitmap.py (scale reso-1)
    u = (np.arange(gw_f, dtype=np.float64) + 0.5) / gw_f
    v = (np.arange(gh_f, dtype=np.float64) + 0.5) / gh_f
    x = u * (w - 1)
    y = v * (h - 1)
    x0 = np.minimum(np.floor(x).astype(np.int64), w - 2)
    y0 = np.minimum(np.floor(y).astype(np.int64), h - 2)
    wx1 = x - x0
    wy1 = y - y0
    # (gw_f, gh_f): x-major to match hypercube flat order (x = i // gh)
    l00 = lum[y0[None, :], x0[:, None]]
    l10 = lum[y0[None, :], x0[:, None] + 1]
    l01 = lum[y0[None, :] + 1, x0[:, None]]
    l11 = lum[y0[None, :] + 1, x0[:, None] + 1]
    val = ((1 - wx1)[:, None] * ((1 - wy1)[None, :] * l00 + wy1[None, :] * l01)
           + wx1[:, None] * ((1 - wy1)[None, :] * l10 + wy1[None, :] * l11))
    m_fine = val * np.sin((np.arange(gh_f) + 0.5) * (float(Pi) / gh_f))[None, :]
    if (gw, gh) == (gw_f, gh_f):
        return m_fine.reshape(-1)
    # coarse: max-pool footprints (see the in-jit path's bias note)
    cx = (np.arange(gw_f) * gw) // gw_f
    cy = (np.arange(gh_f) * gh) // gh_f
    pooled = np.zeros((gw, gh), np.float64)
    np.maximum.at(pooled, (cx[:, None], cy[None, :]), m_fine)
    return pooled.reshape(-1)


# keyed by (id(radiance), shape, grid, kind): the radiance snapshot lives
# on the host Scene object and is replaced (not mutated) on param updates
_FROZEN_CACHE: dict = {}


def _frozen_tables(host_radiance, gw, gh, gw_f, gh_f, kind: str):
    """Host-side (f64 numpy) importance tables, built once per radiance
    snapshot at TRACE time. kind="alias" -> AliasTable (opt-in; O(1)
    sampling but ~1.7x NEE variance under the QMC sampler — measured
    bunny_env_2 MIS, matched grid); kind="cmf" -> Discrete (monotone
    inverse-CDF: keeps QMC stratification; freezing only removes the
    per-frame in-jit mass/cumsum build)."""
    import numpy as np
    key = (id(host_radiance), host_radiance.shape, gw, gh, kind)
    hit = _FROZEN_CACHE.get(key)
    if hit is None:
        mass = _host_mass_grid(host_radiance, gw, gh, gw_f, gh_f)
        if kind == "alias":
            hit = alias_table_host(mass)
        elif kind == "hier":
            hit = hier2d_host(mass, gw, gh)
        else:
            total = mass.sum()
            if not np.isfinite(total) or total <= 0.0:
                mass = np.ones_like(mass)
            pmf = mass.astype(np.float32)
            cmf = np.maximum.accumulate(
                np.cumsum(mass).astype(np.float32))
            hit = Discrete(pmf=pmf, cmf=cmf, total=cmf[-1])
        if len(_FROZEN_CACHE) > 8:
            _FROZEN_CACHE.clear()
        _FROZEN_CACHE[key] = hit
    return hit


def configure_envmap(params: dict, lower: jax.Array, upper: jax.Array,
                     host_radiance=None) -> EnvmapState:
    data = params["radiance"]
    h, w = data.shape[0], data.shape[1]
    gw_f, gh_f = (w - 1) * 2, (h - 1) * 2
    # The reference super-samples the importance grid to 2x the bitmap
    # (envmap.cpp:14) — 2M cells for a 1k envmap, which makes the cmf
    # search + pdf gathers the dominant envmap-NEE cost. The grid
    # is an importance choice, not a correctness surface: the pdf reads
    # the SAME distribution, so any resolution is unbiased (image means
    # agree to 3e-4 on bunny_env) PROVIDED every nonzero-radiance direction
    # keeps nonzero mass. Default div=4 for large grids: +3.8% NEE variance
    # (CPU-measured, seeds A/B); its speed on the GPU is not measured.
    # PSDR_TPU_ENV_RESO_DIV=1 restores exact reference-parity resolution;
    # small grids (<= 2^18 cells, incl. every test envmap) never divide.
    import os as _os
    # Large grids with a host radiance snapshot freeze the importance
    # table at TRACE time (jit constvar): zero per-frame build cost.
    # Two frozen kinds:
    #   PSDR_TPU_ENV_ALIAS=1 (OPT-IN): O(1) alias-method sampling —
    #     grid-size-independent search, but the non-monotone u->cell map
    #     destroys the (0,2)-sequence stratification: measured 1.73x NEE
    #     variance on bunny_env_2 MIS at a matched grid (round 5), an
    #     equal-quality LOSS. Kept available + test-pinned (camera_hit_
    #     prior precedent); alias defaults to the reference-parity div=1
    #     grid since its cost no longer scales with cells.
    #   default: frozen cmf (monotone inverse-CDF keeps QMC
    #     stratification; sampling cost unchanged, per-frame mass build
    #     + cumsum removed). div=4 default as before.
    # PSDR_TPU_ENV_RESO_DIV always wins when set explicitly.
    use_alias = (host_radiance is not None
                 and gw_f * gh_f > (1 << 15)
                 and _os.environ.get("PSDR_TPU_ENV_ALIAS", "0") == "1")
    #   PSDR_TPU_ENV_HIER=1 (OPT-IN until on-chip A/B'd): hierarchical
    #     2D warp — one narrow (N, <=64) row gather per log8 level,
    #     monotone in BOTH sample axes (nested inverse CDFs), so the
    #     (0,2)-sequence keeps genuinely 2D stratification where the
    #     flattened cmf only stratifies the row-major order and alias
    #     none at all. Cost scales with log(cells) -> defaults to the
    #     reference-parity div=1 grid like alias.
    use_hier = (not use_alias and host_radiance is not None
                and gw_f * gh_f > (1 << 15)
                and max(gw_f, gh_f) <= 4096     # hier2d_host f32 bound
                and _os.environ.get("PSDR_TPU_ENV_HIER", "0") == "1")
    use_frozen_cmf = (not use_alias and not use_hier
                      and host_radiance is not None
                      and gw_f * gh_f > (1 << 15)
                      and _os.environ.get("PSDR_TPU_ENV_FROZEN", "1") == "1")
    div_default = "1" if (use_alias or use_hier) else "4"
    div = max(1, int(_os.environ.get("PSDR_TPU_ENV_RESO_DIV", div_default)))
    gw, gh = gw_f, gh_f
    if div > 1 and gw_f * gh_f > (1 << 18):
        gw, gh = max(128, gw_f // div), max(64, gh_f // div)
    if use_alias:
        at = _frozen_tables(host_radiance, gw, gh, gw_f, gh_f, "alias")
        hc = HyperCube(
            distrb=None,
            cells=jnp.zeros((0, 2), jnp.int32),
            resolution=jnp.asarray((gw, gh), jnp.int32),
            unit=1.0 / jnp.asarray((gw, gh), jnp.float32),
            alias=AliasTable(packed=jnp.asarray(at.packed),
                             pmf=jnp.asarray(at.pmf),
                             total=jnp.asarray(at.total)))
    elif use_hier:
        ht = _frozen_tables(host_radiance, gw, gh, gw_f, gh_f, "hier")
        hc = HyperCube(
            distrb=None,
            cells=jnp.zeros((0, 2), jnp.int32),
            resolution=jnp.asarray((gw, gh), jnp.int32),
            unit=1.0 / jnp.asarray((gw, gh), jnp.float32),
            hier=Hier2D(levels=tuple(jnp.asarray(t) for t in ht.levels),
                        pmf=jnp.asarray(ht.pmf),
                        total=jnp.asarray(ht.total)))
    elif use_frozen_cmf:
        d = _frozen_tables(host_radiance, gw, gh, gw_f, gh_f, "cmf")
        hc = HyperCube(
            distrb=Discrete(pmf=jnp.asarray(d.pmf), cmf=jnp.asarray(d.cmf),
                            total=jnp.asarray(d.total)),
            cells=jnp.zeros((0, 2), jnp.int32),
            resolution=jnp.asarray((gw, gh), jnp.int32),
            unit=1.0 / jnp.asarray((gw, gh), jnp.float32))
    elif (gw, gh) == (gw_f, gh_f):
        # reference-parity grid: one bilinear tap per (half-texel) cell
        # center, exactly envmap.cpp:14-26
        hc = hypercube_init((gw, gh))
        uv = (hc.cells.astype(jnp.float32) + 0.5) * hc.unit
        val = eval_bitmap(Bitmap(jax.lax.stop_gradient(data)), uv)
        theta = ((jnp.arange(gw * gh, dtype=jnp.float32) % gh) + 0.5) * (Pi / gh)
        mass = rgb2luminance(val) * jnp.sin(theta)
    else:
        # Divided grid: a single center tap at ~div-texel spacing can miss
        # small bright features (HDRI sun disks) entirely — zero mass means
        # zero NEE pdf, which is BIASED for light-sampling-only estimators.
        # Pool the fine reference grid with MAX over each coarse cell's
        # footprint instead: every direction with nonzero fine-grid mass
        # keeps nonzero coarse mass (conservative over-weighting only
        # affects variance, never bias — the pdf reads the same table).
        fine = hypercube_init((gw_f, gh_f))
        uv = (fine.cells.astype(jnp.float32) + 0.5) * fine.unit
        val = eval_bitmap(Bitmap(jax.lax.stop_gradient(data)), uv)
        theta = ((jnp.arange(gw_f * gh_f, dtype=jnp.float32) % gh_f) + 0.5) * (Pi / gh_f)
        m_fine = (rgb2luminance(val) * jnp.sin(theta)).reshape(gw_f, gh_f)
        cx = (jnp.arange(gw_f, dtype=jnp.int32) * gw) // gw_f
        cy = (jnp.arange(gh_f, dtype=jnp.int32) * gh) // gh_f
        pooled = jax.ops.segment_max(m_fine, cx, num_segments=gw)        # (gw, gh_f)
        pooled = jax.ops.segment_max(pooled.T, cy, num_segments=gh).T    # (gw, gh)
        mass = pooled.reshape(gw * gh)
    if not use_alias and not use_hier and not use_frozen_cmf:
        hc = hypercube_init((gw, gh), mass)
    to_world = params["to_world"]
    return EnvmapState(data=data, scale=params["scale"], to_world=to_world,
                       from_world=jnp.linalg.inv(to_world),
                       cell_distrb=hc, lower=lower, upper=upper)


def envmap_eval_direction(st: EnvmapState, wi: jax.Array,
                          active: jax.Array) -> jax.Array:
    """Radiance arriving *from* direction wi (envmap.cpp:41-58)."""
    v = xform.transform_dir(st.from_world, wi)
    uv = jnp.stack([jnp.arctan2(v[..., 0], -v[..., 2]) * InvTwoPi,
                    safe_acos(v[..., 1]) * InvPi], axis=-1)
    uv = uv - jnp.floor(uv)
    val = eval_bitmap(Bitmap(st.data), uv) * st.scale
    return jnp.where(active[..., None], val, 0.0)


def envmap_sample_direction(st: EnvmapState, sample2: jax.Array):
    """(direction, pdf in solid angle) (envmap.cpp:98-111)."""
    uv, pdf = hypercube_sample_reuse(st.cell_distrb, sample2)
    theta = uv[..., 1] * Pi
    phi = uv[..., 0] * TwoPi
    d = sphdir(theta, phi)
    d = jnp.stack([d[..., 1], d[..., 2], -d[..., 0]], axis=-1)
    inv_sin_theta = safe_rsqrt(jnp.maximum(sqr(d[..., 0]) + sqr(d[..., 2]),
                                           sqr(Epsilon)))
    pdf = jnp.where(pdf > Epsilon, pdf * inv_sin_theta * (0.5 / sqr(Pi)), pdf)
    d = xform.transform_dir(jax.lax.stop_gradient(st.to_world), d)
    return d, pdf


def envmap_sample_position(st: EnvmapState, ref_p: jax.Array,
                           sample2: jax.Array, active: jax.Array) -> PositionSample:
    """Direction sample -> pseudo area sample on the scene AABB
    (envmap.cpp:71-95)."""
    o = jax.lax.stop_gradient(ref_p)
    d, pdf = envmap_sample_direction(st, jax.lax.stop_gradient(sample2))
    t, n, G = ray_intersect_scene_aabb(o, d, st.lower, st.upper)
    return PositionSample(valid=active, pdf=pdf * G, p=o + d * t[..., None],
                          n=n, J=jnp.ones_like(pdf))


def envmap_position_pdf(st: EnvmapState, ref_p: jax.Array, its_p: jax.Array,
                        its_n: jax.Array, active: jax.Array) -> jax.Array:
    """Area-measure pdf of a bounding-mesh hit (envmap.cpp:120-139)."""
    d = jax.lax.stop_gradient(its_p) - jax.lax.stop_gradient(ref_p)
    dist2 = squared_norm(d)
    d = d / safe_sqrt(dist2)[..., None]
    G = jnp.abs(dot(d, jax.lax.stop_gradient(its_n))) / dist2
    d = xform.transform_dir(jax.lax.stop_gradient(st.from_world), d)
    factor = G * safe_rsqrt(jnp.maximum(sqr(d[..., 0]) + sqr(d[..., 2]),
                                        sqr(Epsilon))) * (0.5 / sqr(Pi))
    uv = jnp.stack([jnp.arctan2(d[..., 0], -d[..., 2]) * InvTwoPi,
                    safe_acos(d[..., 1]) * InvPi], axis=-1)
    uv = uv - jnp.floor(uv)
    return jnp.where(active, hypercube_pdf(st.cell_distrb, uv) * factor, 0.0)
