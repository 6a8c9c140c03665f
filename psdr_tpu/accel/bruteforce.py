"""Pure-XLA ray / scene intersection: tiled brute force with a running
closest-hit reduction ("flash-intersect" pattern — tiles of rays x tiles of
triangles, carry (t, id, uv) like flash-attention carries the softmax state).

This is the plain reference backend that runs anywhere. It replaces the
reference's OptiX launch (src/scene/scene_optix.cpp:80-126 +
cuda/psdr_cuda.cu): same contract — detached closest-hit query returning
(tri_id, barycentrics); gradients flow through the *recompute* in
scene.ray_intersect, never through traversal.

Layout note: all Moller-Trumbore intermediates are kept as 2D
(ray_tile, tri_tile) f32 arrays by doing the vector algebra in explicit
x/y/z components — rays broadcast down columns, triangles across rows. A
(R, T, 3) layout would triple the temporaries and get in the way of XLA's
elementwise fusion; the component form keeps every temporary one (R, T)
tile.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.constants import RayEpsilon


class HitRecord(NamedTuple):
    valid: jax.Array   # (N,) bool
    tri_id: jax.Array  # (N,) int32 global triangle index, -1 on miss
    uv: jax.Array      # (N, 2) barycentrics: p = p0 + e1*u + e2*v
    t: jax.Array       # (N,) hit distance (inf on miss)


_INF = jnp.float32(jnp.inf)


def _pad_to(x: jax.Array, n: int, value=0):
    pad = n - x.shape[0]
    if pad == 0:
        return x
    widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, widths, constant_values=value)


def _ceil_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def moller_trumbore_tile(ox, oy, oz, dx, dy, dz, tri9):
    """M-T over a (R,) ray block x (T,) tri block, all-components form.

    ``o*, d*``: (R, 1) ray components. ``tri9``: tuple of 9 (1, T) triangle
    components (p0, e1, e2). Returns (u, v, t) each (R, T).
    """
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = tri9
    # h = d x e2
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    f = 1.0 / jnp.where(jnp.abs(a) < 1e-20, 1e-20, a)
    sx = ox - p0x
    sy = oy - p0y
    sz = oz - p0z
    u = f * (sx * hx + sy * hy + sz * hz)
    # q = s x e1
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    return u, v, t


def _brute_small_f(p0, e1, e2, ray_o, ray_d, active, tmax) -> HitRecord:
    """Statically unrolled closest hit for tiny face sets (the emitter-first
    bounce query's emitter geometry is typically 2-14 faces): every temp is
    a full (N,) lane vector — the tiled path would pad the F axis to a 128
    lane tile (64x waste at F=2) and issue per-chunk row gathers."""
    ox, oy, oz = ray_o[:, 0], ray_o[:, 1], ray_o[:, 2]
    dx, dy, dz = ray_d[:, 0], ray_d[:, 1], ray_d[:, 2]
    n = ox.shape[0]
    t_best = jnp.full((n,), _INF)
    id_best = jnp.full((n,), -1, jnp.int32)
    u_best = jnp.zeros((n,), jnp.float32)
    v_best = jnp.zeros((n,), jnp.float32)
    for j in range(p0.shape[0]):
        tri9 = tuple(arr[j, c] for arr in (p0, e1, e2) for c in range(3))
        u, v, t = moller_trumbore_tile(ox, oy, oz, dx, dy, dz, tri9)
        closer = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                  & (t > RayEpsilon) & (t < tmax) & active & (t < t_best))
        t_best = jnp.where(closer, t, t_best)
        id_best = jnp.where(closer, j, id_best)
        u_best = jnp.where(closer, u, u_best)
        v_best = jnp.where(closer, v, v_best)
    return HitRecord(valid=id_best >= 0, tri_id=id_best,
                     uv=jnp.stack([u_best, v_best], axis=-1), t=t_best)


def ray_intersect_brute(p0: jax.Array, e1: jax.Array, e2: jax.Array,
                        ray_o: jax.Array, ray_d: jax.Array,
                        active: jax.Array | None = None,
                        tmax: jax.Array | None = None,
                        ray_block: int = 1024,
                        tri_block: int = 512) -> HitRecord:
    """Closest-hit over all triangles. All inputs are treated as detached.

    p0/e1/e2: (F, 3) triangle SoA. ray_o/ray_d: (N, 3).
    """
    p0, e1, e2, ray_o, ray_d = map(jax.lax.stop_gradient,
                                   (p0, e1, e2, ray_o, ray_d))
    n_rays = ray_o.shape[0]
    n_tris = p0.shape[0]

    if active is None:
        active = jnp.ones((n_rays,), bool)
    else:
        active = jax.lax.stop_gradient(active)
    if tmax is None:
        tmax = jnp.full((n_rays,), _INF)
    else:
        tmax = jax.lax.stop_gradient(jnp.broadcast_to(tmax, (n_rays,)))

    if n_tris <= 24:
        return _brute_small_f(p0, e1, e2, ray_o, ray_d, active, tmax)

    tb = min(tri_block, max(8, n_tris))
    f_pad = _ceil_to(n_tris, tb)
    n_chunks = f_pad // tb
    # 9 per-component triangle arrays, chunked: (n_chunks, tb)
    tri_comp = [
        _pad_to(arr[:, c], f_pad).reshape(n_chunks, tb)
        for arr in (p0, e1, e2) for c in range(3)
    ]
    tvalid = _pad_to(jnp.ones((n_tris,), bool), f_pad).reshape(n_chunks, tb)

    rb = min(ray_block, max(8, n_rays))
    r_pad = _ceil_to(n_rays, rb)
    n_rblocks = r_pad // rb
    ro = _pad_to(ray_o, r_pad).reshape(n_rblocks, rb, 3)
    rd = _pad_to(ray_d, r_pad).reshape(n_rblocks, rb, 3)
    ract = _pad_to(active, r_pad).reshape(n_rblocks, rb)
    rtmax = _pad_to(tmax, r_pad, value=0.0).reshape(n_rblocks, rb)

    def ray_block_fn(args):
        ro_b, rd_b, act_b, tmax_b = args
        ox, oy, oz = (ro_b[:, c:c + 1] for c in range(3))
        dx, dy, dz = (rd_b[:, c:c + 1] for c in range(3))

        def body(carry, chunk):
            t_best, id_best, uv_best = carry
            *tri9, cvalid, base = chunk
            tri9 = tuple(c[None, :] for c in tri9)
            u, v, t = moller_trumbore_tile(ox, oy, oz, dx, dy, dz, tri9)

            hit = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                   & (t > RayEpsilon) & (t < tmax_b[:, None])
                   & cvalid[None, :] & act_b[:, None])
            tm = jnp.where(hit, t, _INF)
            j = jnp.argmin(tm, axis=1)
            rows = jnp.arange(tm.shape[0])
            t_c = tm[rows, j]
            closer = t_c < t_best
            t_best = jnp.where(closer, t_c, t_best)
            id_best = jnp.where(closer, base + j.astype(jnp.int32), id_best)
            uv_c = jnp.stack([u[rows, j], v[rows, j]], axis=-1)
            uv_best = jnp.where(closer[:, None], uv_c, uv_best)
            return (t_best, id_best, uv_best), None

        init = (jnp.full((rb,), _INF),
                jnp.full((rb,), -1, jnp.int32),
                jnp.zeros((rb, 2), jnp.float32))
        bases = (jnp.arange(n_chunks, dtype=jnp.int32) * tb)
        (t_best, id_best, uv_best), _ = jax.lax.scan(
            body, init, (*tri_comp, tvalid, bases))
        return t_best, id_best, uv_best

    if n_rblocks == 1:
        t_b, id_b, uv_b = ray_block_fn((ro[0], rd[0], ract[0], rtmax[0]))
        t_all, id_all, uv_all = t_b[None], id_b[None], uv_b[None]
    else:
        t_all, id_all, uv_all = jax.lax.map(ray_block_fn, (ro, rd, ract, rtmax))

    t = t_all.reshape(r_pad)[:n_rays]
    tri_id = id_all.reshape(r_pad)[:n_rays]
    uv = uv_all.reshape(r_pad, 2)[:n_rays]
    return HitRecord(valid=tri_id >= 0, tri_id=tri_id, uv=uv, t=t)
