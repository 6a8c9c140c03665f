"""Implicit BVH: complete binary tree over Morton-sorted
triangle chunks.

Replaces the reference's OptiX GAS + RT-core traversal
(src/scene/scene_optix.cpp:80-126, include/psdr/scene/optix.h:277-340) with
a design shaped for XLA instead of RT cores:

* **Static topology, dynamic refit.** The tree is a *complete* binary tree
  over ``P`` (power-of-two) leaf chunks of ``L`` Morton-sorted triangles.
  Topology (the triangle permutation and the arithmetic skip links) depends
  only on the initial geometry and is built once on the host; per-iteration
  rebuilds inside ``jit`` (the reference re-runs optixAccelBuild every
  configure) collapse to an AABB *refit*: log2(P) dense min/max reductions —
  no pointers, no host round-trip, fully traceable.
* **Heap indexing + precomputed skip links.** Node ``i`` has children
  ``2i, 2i+1``; leaves live at ``[P, 2P)``. Stackless preorder traversal
  needs only ``next-if-hit = 2i`` and a static ``skip[i]`` table
  (the next preorder node after subtree ``i``), so the per-ray state is one
  int32 — no traversal stacks.
* **Lockstep wavefront traversal.** All rays in a block step through their
  own node pointers simultaneously (gather node AABB -> slab test ->
  masked leaf Moller-Trumbore -> advance), with closest-hit distance used
  as tmax for box pruning. Like the reference, traversal is detached;
  gradients flow through the differentiable recompute in
  ``scene.ray_intersect`` (scene.cpp:289-384), never through the tree.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.constants import RayEpsilon
from .bruteforce import HitRecord, _pad_to, _ceil_to

_INF = jnp.float32(jnp.inf)


class BVHTopology(NamedTuple):
    """Static (host-built) part: depends on triangle order, not positions."""
    perm: np.ndarray        # (P*L,) int32: padded-slot -> original tri id, -1 pad
    skip: np.ndarray        # (2P,) int32: preorder skip links, 0 = done
    num_leaves: int         # P (power of two)
    leaf_size: int          # L
    num_faces: int          # original (unpadded) triangle count


class BVH(NamedTuple):
    """Device-side refit result consumed by traversal (all detached).

    Layouts are packed for one-row-per-step gathers: the traversal loop
    issues exactly two f32 gathers (node row, leaf-triangle row) and one
    int32 gather (skip link) per iteration instead of many small
    per-component gathers inside the while_loop.
    """
    nodes: jax.Array        # (2P, 6) heap order: [lo.xyz, hi.xyz]; row 0 unused
    node_mask: jax.Array    # (2P,) bool: subtree contains any real triangle.
                            # Needed because an "empty" (+inf,-inf) AABB turns
                            # into (-inf,+inf) under the slab min/max swap and
                            # would hit every ray.
    leaf_tris: jax.Array    # (P, 9L): per leaf [p0x*L, p0y*L, p0z*L, e1x*L, ...]
    tri_valid: jax.Array    # (P, L) bool
    perm: jax.Array         # (P*L,) int32 (-1 for padding)
    skip: jax.Array         # (2P,) int32 static preorder skip links

    # static tree dimensions derived from (trace-time) shapes, so a BVH that
    # crossed a jit boundary keeps them as Python ints, never tracers
    @property
    def num_leaves(self) -> int:
        return self.nodes.shape[0] // 2

    @property
    def leaf_size(self) -> int:
        return self.leaf_tris.shape[1] // 9


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10-bit per-axis quantized coords into 30-bit Morton codes."""
    def expand(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v
    return (expand(x[:, 0]) << np.uint64(2)) | (expand(x[:, 1]) << np.uint64(1)) \
        | expand(x[:, 2])


def build_bvh_topology(p0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                       leaf_size: int = 4) -> BVHTopology:
    """Host-side build: Morton-sort triangle centroids, chunk into power-of-two
    leaves, precompute the arithmetic preorder skip table. Uses the C++
    native builder when available (the OptiX-GAS-build analog)."""
    from .. import native
    f = p0.shape[0]
    nat = native.morton_topology(np.asarray(p0), np.asarray(e1),
                                 np.asarray(e2), leaf_size) \
        if native.available() else None
    if nat is not None:
        perm, skip, P = nat
        return BVHTopology(perm=perm, skip=skip, num_leaves=P,
                           leaf_size=leaf_size, num_faces=f)
    centroid = p0 + (e1 + e2) / 3.0
    lo = centroid.min(axis=0)
    extent = np.maximum(centroid.max(axis=0) - lo, 1e-12)
    q = np.clip(((centroid - lo) / extent) * 1023.0, 0, 1023).astype(np.uint32)
    order = np.argsort(_morton3(q), kind="stable").astype(np.int32)

    num_leaves = _next_pow2(-(-f // leaf_size))
    perm = np.full(num_leaves * leaf_size, -1, np.int32)
    perm[:f] = order

    n = 2 * num_leaves
    skip = np.zeros(n, np.int32)
    for i in range(1, n):
        k = i
        while (k & 1) and k > 1:
            k >>= 1
        skip[i] = 0 if k <= 1 else k + 1
    return BVHTopology(perm=perm, skip=skip, num_leaves=num_leaves,
                       leaf_size=leaf_size, num_faces=f)


def refit_bvh(topo: BVHTopology, p0: jax.Array, e1: jax.Array,
              e2: jax.Array) -> BVH:
    """Pure-JAX AABB refit: leaf AABBs from permuted triangles, internal
    levels by pairwise min/max up the complete tree. All detached."""
    sg = jax.lax.stop_gradient
    p0, e1, e2 = sg(p0), sg(e1), sg(e2)
    perm = jnp.asarray(topo.perm)
    idx = jnp.maximum(perm, 0)
    valid = perm >= 0
    # padded-slot degenerate tris: p0 at +inf never hits nor affects AABBs
    tp0 = jnp.where(valid[:, None], p0[idx], _INF)
    te1 = jnp.where(valid[:, None], e1[idx], 0.0)
    te2 = jnp.where(valid[:, None], e2[idx], 0.0)

    P, L = topo.num_leaves, topo.leaf_size
    v0 = tp0
    v1 = jnp.where(valid[:, None], tp0 + te1, _INF)
    v2 = jnp.where(valid[:, None], tp0 + te2, _INF)
    tri_lo = jnp.minimum(jnp.minimum(v0, v1), v2)
    tri_hi = jnp.where(valid[:, None],
                       jnp.maximum(jnp.maximum(v0, v1), v2), -_INF)
    leaf_lo = tri_lo.reshape(P, L, 3).min(axis=1)
    leaf_hi = tri_hi.reshape(P, L, 3).max(axis=1)

    leaf_mask = valid.reshape(P, L).any(axis=1)
    levels_lo = [leaf_lo]
    levels_hi = [leaf_hi]
    levels_mask = [leaf_mask]
    while levels_lo[-1].shape[0] > 1:
        lo = levels_lo[-1].reshape(-1, 2, 3)
        hi = levels_hi[-1].reshape(-1, 2, 3)
        levels_lo.append(lo.min(axis=1))
        levels_hi.append(hi.max(axis=1))
        levels_mask.append(levels_mask[-1].reshape(-1, 2).any(axis=1))
    # heap order: nodes[1] = root ... nodes[P:2P] = leaves; index 0 unused
    node_lo = jnp.concatenate([jnp.full((1, 3), _INF)]
                              + [l for l in reversed(levels_lo)])
    node_hi = jnp.concatenate([jnp.full((1, 3), -_INF)]
                              + [h for h in reversed(levels_hi)])
    nodes = jnp.concatenate([node_lo, node_hi], axis=-1)  # (2P, 6)
    node_mask = jnp.concatenate([jnp.zeros((1,), bool)]
                                + [m for m in reversed(levels_mask)])

    # leaf_tris rows: 9 components x L contiguous values
    comps = [tp0[:, 0], tp0[:, 1], tp0[:, 2], te1[:, 0], te1[:, 1],
             te1[:, 2], te2[:, 0], te2[:, 1], te2[:, 2]]
    leaf_tris = jnp.concatenate(
        [c.reshape(P, L) for c in comps], axis=-1)  # (P, 9L)
    return BVH(nodes=nodes, node_mask=node_mask, leaf_tris=leaf_tris,
               tri_valid=valid.reshape(P, L), perm=perm,
               skip=jnp.asarray(topo.skip))


def ray_intersect_culled(bvh: BVH, ray_o: jax.Array, ray_d: jax.Array,
                         active: jax.Array | None = None,
                         tmax: jax.Array | None = None,
                         ray_block: int = 2048,
                         tri_block: int = 512) -> HitRecord:
    """Block-culled dense intersection in plain XLA (the ``"culled"``
    backend; ``accel/pallas_kernel.py`` is the GPU kernel of the same cut).

    Instead of a per-ray pointer walk, cut the
    implicit tree at the level with B = P*L/T nodes ("tri-blocks" of T
    Morton-adjacent triangles):

    1. cull: dense (R, B) slab tests — pure elementwise, no gathers;
    2. compact: the list of blocks hit by ANY ray of the R-block (host-free,
       `cumsum` + scatter);
    3. sweep: a while_loop over just the occupied blocks; each iteration
       dynamic-slices one (9T,) packed triangle row (contiguous, not a
       gather) and runs a dense (R, T) component-form Moller-Trumbore tile
       with running closest-hit reduction.

    Work scales with (occupied blocks) x R x T instead of R x F; every
    compute op is a dense 2D tile, and loop trip counts are tens, not
    thousands. The ray blocks run one after another under ``lax.map``.
    """
    from .bruteforce import moller_trumbore_tile

    sg = jax.lax.stop_gradient
    ray_o, ray_d = sg(ray_o), sg(ray_d)
    n_rays = ray_o.shape[0]
    P, L = bvh.num_leaves, bvh.leaf_size

    n_tris_padded = P * L
    T = min(tri_block, n_tris_padded)
    n_blocks = max(1, n_tris_padded // T)
    # cut level: heap level with n_blocks nodes occupies [n_blocks, 2*n_blocks)
    blocks = bvh.nodes[n_blocks:2 * n_blocks]          # (B, 6)
    # (P, 9L) -> (B, leaves/block, 9, L) -> (B, 9, T) -> (B, 9T)
    lpb = P // n_blocks
    tri_rows = (bvh.leaf_tris.reshape(n_blocks, lpb, 9, L)
                .transpose(0, 2, 1, 3).reshape(n_blocks, 9 * T))
    valid_rows = bvh.tri_valid.reshape(n_blocks, T)

    if active is None:
        active = jnp.ones((n_rays,), bool)
    else:
        active = sg(active)
    if tmax is None:
        tmax = jnp.full((n_rays,), _INF)
    else:
        tmax = sg(jnp.broadcast_to(tmax, (n_rays,)))

    rb = min(ray_block, max(8, n_rays))
    r_pad = _ceil_to(n_rays, rb)
    n_rblocks = r_pad // rb
    ro = _pad_to(ray_o, r_pad).reshape(n_rblocks, rb, 3)
    rd = _pad_to(ray_d, r_pad).reshape(n_rblocks, rb, 3)
    ract = _pad_to(active, r_pad).reshape(n_rblocks, rb)
    rtmax = _pad_to(tmax, r_pad, value=0.0).reshape(n_rblocks, rb)

    blo = blocks[:, :3]
    bhi = blocks[:, 3:]

    def block_fn(args):
        o, d, act, tm = args
        inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-20,
                                jnp.where(d < 0, -1e-20, 1e-20), d)
        ox, oy, oz = (o[:, c:c + 1] for c in range(3))
        dx, dy, dz = (d[:, c:c + 1] for c in range(3))

        # --- cull: (R, B) slab tests, one component at a time ---
        tn = jnp.full((rb, n_blocks), RayEpsilon)
        tf = jnp.broadcast_to(tm[:, None], (rb, n_blocks))
        for c in range(3):
            t0 = (blo[None, :, c] - o[:, c:c + 1]) * inv_d[:, c:c + 1]
            t1 = (bhi[None, :, c] - o[:, c:c + 1]) * inv_d[:, c:c + 1]
            tn = jnp.maximum(tn, jnp.minimum(t0, t1))
            tf = jnp.minimum(tf, jnp.maximum(t0, t1))
        hit_any = (jnp.any((tn <= tf) & act[:, None], axis=0)
                   & bvh.node_mask[n_blocks:2 * n_blocks])    # (B,)

        # --- compact occupied block ids to the front ---
        order = jnp.argsort(~hit_any)           # occupied first, stable
        count = jnp.sum(hit_any.astype(jnp.int32))

        def cond(state):
            j, *_ = state
            return j < count

        def body(state):
            j, t_best, id_best, uv_best = state
            b = order[j]
            row = jax.lax.dynamic_slice(tri_rows, (b, 0), (1, 9 * T))
            tri9 = tuple(row[0, k * T:(k + 1) * T][None, :] for k in range(9))
            u, v, t = moller_trumbore_tile(ox, oy, oz, dx, dy, dz, tri9)
            vrow = jax.lax.dynamic_slice(valid_rows, (b, 0), (1, T))
            ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                  & (t > RayEpsilon) & (t < t_best[:, None])
                  & vrow & act[:, None])
            t_m = jnp.where(ok, t, _INF)
            jj = jnp.argmin(t_m, axis=1)
            rows_i = jnp.arange(rb)
            t_c = t_m[rows_i, jj]
            closer = t_c < t_best
            t_best = jnp.where(closer, t_c, t_best)
            id_best = jnp.where(closer, b * T + jj.astype(jnp.int32), id_best)
            uv_c = jnp.stack([u[rows_i, jj], v[rows_i, jj]], axis=-1)
            uv_best = jnp.where(closer[:, None], uv_c, uv_best)
            return j + 1, t_best, id_best, uv_best

        init = (jnp.int32(0), tm, jnp.full((rb,), -1, jnp.int32),
                jnp.zeros((rb, 2), jnp.float32))
        _, t_best, id_best, uv_best = jax.lax.while_loop(cond, body, init)
        return t_best, id_best, uv_best

    if n_rblocks == 1:
        t_b, id_b, uv_b = block_fn((ro[0], rd[0], ract[0], rtmax[0]))
        t_all, id_all, uv_all = t_b[None], id_b[None], uv_b[None]
    else:
        t_all, id_all, uv_all = jax.lax.map(
            block_fn, (ro, rd, ract, rtmax))

    t = jnp.where(id_all.reshape(r_pad) >= 0, t_all.reshape(r_pad),
                  _INF)[:n_rays]
    slot = id_all.reshape(r_pad)[:n_rays]
    tri_id = jnp.where(slot >= 0, bvh.perm[jnp.maximum(slot, 0)], -1)
    uv = uv_all.reshape(r_pad, 2)[:n_rays]
    return HitRecord(valid=tri_id >= 0, tri_id=tri_id, uv=uv, t=t)


def ray_intersect_bvh(bvh: BVH, ray_o: jax.Array, ray_d: jax.Array,
                      active: jax.Array | None = None,
                      tmax: jax.Array | None = None,
                      ray_block: int = 8192) -> HitRecord:
    """Lockstep stackless closest-hit traversal. Returns global tri ids."""
    sg = jax.lax.stop_gradient
    ray_o, ray_d = sg(ray_o), sg(ray_d)
    n_rays = ray_o.shape[0]
    P, L = bvh.num_leaves, bvh.leaf_size
    skip = bvh.skip

    if active is None:
        active = jnp.ones((n_rays,), bool)
    else:
        active = sg(active)
    if tmax is None:
        tmax = jnp.full((n_rays,), _INF)
    else:
        tmax = sg(jnp.broadcast_to(tmax, (n_rays,)))

    rb = min(ray_block, max(8, n_rays))
    r_pad = _ceil_to(n_rays, rb)
    n_rblocks = r_pad // rb
    ro = _pad_to(ray_o, r_pad).reshape(n_rblocks, rb, 3)
    rd = _pad_to(ray_d, r_pad).reshape(n_rblocks, rb, 3)
    ract = _pad_to(active, r_pad).reshape(n_rblocks, rb)
    rtmax = _pad_to(tmax, r_pad, value=0.0).reshape(n_rblocks, rb)

    def block_fn(args):
        o, d, act, tm = args
        inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-20,
                                jnp.where(d < 0, -1e-20, 1e-20), d)
        ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
        dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]

        def cond(state):
            node, *_ = state
            return jnp.any(node > 0)

        def body(state):
            node, t_best, id_best, uv_best = state
            ni = jnp.maximum(node, 1)
            row = bvh.nodes[ni]                       # (rb, 6) one gather
            t0 = (row[:, :3] - o) * inv_d
            t1 = (row[:, 3:] - o) * inv_d
            tnear = jnp.max(jnp.minimum(t0, t1), axis=-1)
            tfar = jnp.min(jnp.maximum(t0, t1), axis=-1)
            box_hit = (tnear <= tfar) & (tfar > RayEpsilon) \
                & (tnear < t_best) & bvh.node_mask[ni]

            is_leaf = ni >= P
            leaf = jnp.where(is_leaf, ni - P, 0)
            trow = bvh.leaf_tris[leaf]                # (rb, 9L) one gather
            c = [trow[:, k * L:(k + 1) * L] for k in range(9)]
            # Moller-Trumbore vectorized over the L leaf triangles
            hx = dy[:, None] * c[8] - dz[:, None] * c[7]
            hy = dz[:, None] * c[6] - dx[:, None] * c[8]
            hz = dx[:, None] * c[7] - dy[:, None] * c[6]
            a = c[3] * hx + c[4] * hy + c[5] * hz
            f = 1.0 / jnp.where(jnp.abs(a) < 1e-20, 1e-20, a)
            sx = ox[:, None] - c[0]
            sy = oy[:, None] - c[1]
            sz = oz[:, None] - c[2]
            u = f * (sx * hx + sy * hy + sz * hz)
            qx = sy * c[5] - sz * c[4]
            qy = sz * c[3] - sx * c[5]
            qz = sx * c[4] - sy * c[3]
            v = f * (dx[:, None] * qx + dy[:, None] * qy + dz[:, None] * qz)
            t = f * (c[6] * qx + c[7] * qy + c[8] * qz)

            do_tri = box_hit & is_leaf & (node > 0)
            ok = (do_tri[:, None] & bvh.tri_valid[leaf] & (u >= 0.0)
                  & (v >= 0.0) & (u + v <= 1.0) & (t > RayEpsilon)
                  & (t < t_best[:, None]))
            t_m = jnp.where(ok, t, _INF)
            j = jnp.argmin(t_m, axis=-1)
            rows_i = jnp.arange(t_m.shape[0])
            t_c = t_m[rows_i, j]
            closer = t_c < t_best
            t_best = jnp.where(closer, t_c, t_best)
            id_best = jnp.where(closer, leaf * L + j.astype(jnp.int32),
                                id_best)
            uv_c = jnp.stack([u[rows_i, j], v[rows_i, j]], axis=-1)
            uv_best = jnp.where(closer[:, None], uv_c, uv_best)

            descend = box_hit & ~is_leaf
            nxt = jnp.where(descend, 2 * ni, skip[ni])  # one int gather
            node = jnp.where(node > 0, nxt, 0)
            return node, t_best, id_best, uv_best

        node0 = jnp.where(act, 1, 0)
        init = (node0, tm, jnp.full((rb,), -1, jnp.int32),
                jnp.zeros((rb, 2), jnp.float32))
        _, t_best, id_best, uv_best = jax.lax.while_loop(cond, body, init)
        return t_best, id_best, uv_best

    if n_rblocks == 1:
        t_b, id_b, uv_b = block_fn((ro[0], rd[0], ract[0], rtmax[0]))
        t_all, id_all, uv_all = t_b[None], id_b[None], uv_b[None]
    else:
        t_all, id_all, uv_all = jax.lax.map(
            block_fn, (ro, rd, ract, rtmax))

    t = jnp.where(id_all.reshape(r_pad) >= 0, t_all.reshape(r_pad), _INF)[:n_rays]
    slot = id_all.reshape(r_pad)[:n_rays]
    tri_id = jnp.where(slot >= 0, bvh.perm[jnp.maximum(slot, 0)], -1)
    uv = uv_all.reshape(r_pad, 2)[:n_rays]
    return HitRecord(valid=tri_id >= 0, tri_id=tri_id, uv=uv, t=t)
