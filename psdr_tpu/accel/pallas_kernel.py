"""Block-culled ray / triangle intersection as a Pallas kernel on the Triton
route (NVIDIA GPUs).

One program owns a small ray block (``ray_block`` lanes, e.g. one pixel's
samples in tile-ordered camera wavefronts) and walks the top of the
implicit BVH (``accel/bvh.py``) down to the *block level*: the heap level
whose nodes each cover ``tri_block`` Morton-adjacent triangles. Traversal is
a stackless preorder walk with the precomputed skip links, shared by the
whole ray block (a packet): a node is entered iff some live lane's slab
interval meets it within that lane's current best ``t``. At a block-level
node the program runs a dense (ray_block, tri_block) Moller-Trumbore tile
against the block's triangle rows and folds it into the running
(t, id, u, v), which stay in registers for the whole walk. Nothing carries
over between programs.

Triangle rows are SoA, 16 rows per block (p0 e1 e2 xyz, validity, pad), so
each component load is one contiguous ``tri_block``-wide row; the whole
table of a 20k-triangle scene is about 1.3 MB and stays in L2.

``any_hit=True`` (occlusion queries) drops decided lanes from the box tests
and ends the walk once every active lane has a hit.

Same contract as ``ray_intersect_culled``: detached, slot ids mapped back
to global triangle ids through the BVH permutation.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..core.constants import RayEpsilon
from .bruteforce import HitRecord, _ceil_to, _pad_to

_INF = float("inf")

# Chosen on an H100 at the flagship shapes (PERF.md, "Intersection").
RAY_BLOCK = 32
TRI_BLOCK = 16
NUM_WARPS = 2


def _kernel(rays_ref, nodes_ref, skip_ref, tris_ref,
            t_ref, id_ref, u_ref, v_ref, *, n_blocks, tri_block, any_hit):
    T = tri_block
    o = [rays_ref[k, :] for k in range(3)]
    d = [rays_ref[3 + k, :] for k in range(3)]
    tmax = rays_ref[6, :]
    act = rays_ref[7, :] > 0.0
    inv = [1.0 / jnp.where(jnp.abs(c) < 1e-20,
                           jnp.where(c < 0, -1e-20, 1e-20), c) for c in d]
    R = tmax.shape[0]
    ox, oy, oz = (c[:, None] for c in o)
    dx, dy, dz = (c[:, None] for c in d)
    col = jax.lax.broadcasted_iota(jnp.int32, (R, T), 1)

    def any_lane(mask):
        return jnp.max(mask.astype(jnp.int32)) > 0

    def box_live(node, tb, ib):
        tn = jnp.full_like(tb, RayEpsilon)
        tf = tb
        for k in range(3):
            t0 = (nodes_ref[node, k] - o[k]) * inv[k]
            t1 = (nodes_ref[node, 3 + k] - o[k]) * inv[k]
            tn = jnp.maximum(tn, jnp.minimum(t0, t1))
            tf = jnp.minimum(tf, jnp.maximum(t0, t1))
        live = (tn <= tf) & act
        if any_hit:
            live = live & (ib < 0)
        return any_lane(live) & (nodes_ref[node, 6] > 0.0)

    def mt_block(b, state):
        tb, ib, ub, vb = state
        base = b * 16
        p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z, valid = (
            tris_ref[base + k, :][None, :] for k in range(10))
        hx = dy * e2z - dz * e2y
        hy = dz * e2x - dx * e2z
        hz = dx * e2y - dy * e2x
        a = e1x * hx + e1y * hy + e1z * hz
        f = 1.0 / jnp.where(jnp.abs(a) < 1e-20, 1e-20, a)
        sx = ox - p0x
        sy = oy - p0y
        sz = oz - p0z
        u = f * (sx * hx + sy * hy + sz * hz)
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        v = f * (dx * qx + dy * qy + dz * qz)
        t = f * (e2x * qx + e2y * qy + e2z * qz)
        ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > RayEpsilon)
              & (t < tb[:, None]) & (valid > 0.0) & act[:, None])
        t_m = jnp.where(ok, t, _INF)
        t_c = jnp.min(t_m, axis=1)
        # first column reaching the minimum (argmin's tie rule)
        j = jnp.min(jnp.where(t_m == t_c[:, None], col, T), axis=1)
        pick = col == j[:, None]
        u_c = jnp.sum(jnp.where(pick, u, 0.0), axis=1)
        v_c = jnp.sum(jnp.where(pick, v, 0.0), axis=1)
        closer = t_c < tb
        return (jnp.where(closer, t_c, tb),
                jnp.where(closer, b * T + j, ib),
                jnp.where(closer, u_c, ub),
                jnp.where(closer, v_c, vb))

    def cond(carry):
        go = carry[0] > 0
        if any_hit:
            go = go & any_lane(act & (carry[2] < 0))
        return go

    def body(carry):
        node, *state = carry
        live = box_live(node, state[0], state[1])
        at_block = node >= n_blocks
        state = jax.lax.cond(live & at_block,
                             lambda s: mt_block(node - n_blocks, s),
                             lambda s: s, tuple(state))
        nxt = jnp.where(live & ~at_block, 2 * node, skip_ref[node])
        return (nxt, *state)

    init = (jnp.int32(1), tmax, jnp.full((R,), -1, jnp.int32),
            jnp.zeros((R,), jnp.float32), jnp.zeros((R,), jnp.float32))
    _, tb, ib, ub, vb = jax.lax.while_loop(cond, body, init)
    t_ref[...] = tb
    id_ref[...] = ib
    u_ref[...] = ub
    v_ref[...] = vb


def block_tables(bvh, tri_block: int):
    """(T, n_blocks, nodes, skip, tris): the BVH cut at the level whose nodes
    cover ``T`` triangles each, as the kernel reads it. ``nodes`` (2B, 8):
    lo.xyz, hi.xyz, non-empty mask, pad; ``skip`` (2B,) preorder skip links;
    ``tris`` (16B, T): per block p0 e1 e2 xyz rows, validity, zero rows."""
    P, L = bvh.num_leaves, bvh.leaf_size
    if L & (L - 1):
        raise ValueError(f"leaf size {L} is not a power of two")
    T = max(L, min(tri_block, P * L))
    n_blocks = P * L // T
    lpb = P // n_blocks
    nodes = jnp.concatenate([
        bvh.nodes[:2 * n_blocks],
        bvh.node_mask[:2 * n_blocks].astype(jnp.float32)[:, None],
        jnp.zeros((2 * n_blocks, 1), jnp.float32)], axis=1)
    tri_rows = (bvh.leaf_tris.reshape(n_blocks, lpb, 9, L)
                .transpose(0, 2, 1, 3).reshape(n_blocks, 9, T))
    valid_rows = bvh.tri_valid.reshape(n_blocks, 1, T).astype(jnp.float32)
    tris = jnp.concatenate(
        [tri_rows, valid_rows, jnp.zeros((n_blocks, 6, T), jnp.float32)],
        axis=1).reshape(n_blocks * 16, T)
    return T, n_blocks, nodes, bvh.skip[:2 * n_blocks], tris


def ray_intersect_pallas(bvh, ray_o: jax.Array, ray_d: jax.Array,
                         active: jax.Array | None = None,
                         tmax: jax.Array | None = None,
                         any_hit: bool = False,
                         ray_block: int = RAY_BLOCK,
                         tri_block: int = TRI_BLOCK) -> HitRecord:
    """Block-culled closest hit (or, with ``any_hit=True``, *a* hit inside
    ``tmax``) through the Triton-route kernel. Runs interpreted only when
    the default backend is the CPU (the tests); elsewhere it is compiled."""
    if ray_block & (ray_block - 1):
        raise ValueError(f"ray_block {ray_block} is not a power of two")
    sg = jax.lax.stop_gradient
    ray_o, ray_d = sg(ray_o), sg(ray_d)
    n_rays = ray_o.shape[0]
    if active is None:
        active = jnp.ones((n_rays,), bool)
    if tmax is None:
        tmax = jnp.full((n_rays,), _INF)
    tmax = jnp.broadcast_to(sg(tmax), (n_rays,))
    T, n_blocks, nodes, skip, tris = block_tables(bvh, tri_block)

    R = ray_block
    r_pad = _ceil_to(max(n_rays, 1), R)
    rays = jnp.stack(
        [_pad_to(ray_o[:, c], r_pad) for c in range(3)]
        + [_pad_to(ray_d[:, c], r_pad) for c in range(3)]
        + [_pad_to(tmax, r_pad, value=0.0),
           _pad_to(sg(active).astype(jnp.float32), r_pad)])  # (8, r_pad)

    lane = pl.BlockSpec((R,), lambda i: (i,))
    whole = pl.BlockSpec(memory_space=pl.ANY)
    t, slot, u, v = pl.pallas_call(
        partial(_kernel, n_blocks=n_blocks, tri_block=T, any_hit=any_hit),
        out_shape=(jax.ShapeDtypeStruct((r_pad,), jnp.float32),
                   jax.ShapeDtypeStruct((r_pad,), jnp.int32),
                   jax.ShapeDtypeStruct((r_pad,), jnp.float32),
                   jax.ShapeDtypeStruct((r_pad,), jnp.float32)),
        grid=(r_pad // R,),
        in_specs=[pl.BlockSpec((8, R), lambda i: (0, i)), whole, whole,
                  whole],
        out_specs=(lane, lane, lane, lane),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        interpret=jax.default_backend() == "cpu",
        name="ray_intersect_culled_triton",
    )(rays, nodes, skip, tris)

    slot = slot[:n_rays]
    tri_id = jnp.where(slot >= 0, bvh.perm[jnp.maximum(slot, 0)], -1)
    valid = tri_id >= 0
    return HitRecord(valid=valid, tri_id=tri_id,
                     uv=jnp.stack([u[:n_rays], v[:n_rays]], axis=-1),
                     t=jnp.where(valid, t[:n_rays], _INF))
