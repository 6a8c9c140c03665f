"""Integrator base: wavefront generation, image accumulation, and the
primary-boundary (silhouette-edge) estimator shared by all integrators.

Parity reference: psdr-cuda src/integrator/integrator.cpp —
* ``render_interior`` == __render<ad> (integrator.cpp:63-95): one lane per
  (pixel, sample), Li, non-finite scrub, segment-sum into the image;
* ``render_primary_edges`` == integrator.cpp:98-119: screen-edge sampling,
  delta_L = Li(ray_n) - Li(ray_p) on detached rays, contribution
  x_dot_n * delta_L / pdf with the ``value - stop_gradient(value)`` trick
  making it a pure-gradient term.
"""
from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

from ..core.constants import RayEpsilon
from ..core.math import ray_intersect_triangle, scrub_nonfinite
from ..core.records import RenderOptions
from ..core.sampler import RngStream
from ..scene.scene import FlatScene, Scene
from ..sensor.perspective import sample_primary_edge, sample_primary_ray

sg = jax.lax.stop_gradient


def camera_prior_rows(flat: FlatScene, sensor_id: int, pix_order: jax.Array,
                      opts: RenderOptions) -> jax.Array:
    """Detached per-pixel candidate rows for the camera-hit prior
    (RenderOptions.camera_hit_prior): trace one pixel-center ray per pixel
    and pack the hit triangle's [p0 e1 e2 tri_id] as a (num_pixels, 10)
    float row, in TILE order — the interior pass's pixel-major chunks then
    read their candidates as a contiguous slice (no per-lane gather).
    Missed pixels get an all-zero (degenerate) row whose candidate MT
    always fails, i.e. an unbounded query."""
    from ..core.gather import gather_rows
    from ..scene.scene import _closest_hit

    from ..scene.scene import detach_flat
    flat_det = detach_flat(flat)
    base = jnp.stack([(pix_order % opts.width).astype(jnp.float32),
                      (pix_order // opts.width).astype(jnp.float32)],
                     axis=-1)
    samples = (base + 0.5) / jnp.array([opts.width, opts.height], jnp.float32)
    ray = sample_primary_ray(flat_det.sensors[sensor_id], samples)
    hit = _closest_hit(flat_det, ray, jnp.ones(pix_order.shape, bool))
    rows = gather_rows(flat_det.face_table,
                       jnp.maximum(hit.tri_id, 0))[:, 0:9]
    rows = jnp.where(hit.valid[..., None], rows, 0.0)
    # tri ids are < 2^24 (enforced at build), so f32 round-trips exactly
    tid = jnp.where(hit.valid, hit.tri_id, -1).astype(jnp.float32)
    return jnp.concatenate([rows, tid[:, None]], axis=1)


def camera_prior_for_rays(prior_rows_c: jax.Array, ray, spp: int):
    """Per-lane prior tuple for ray_intersect_with_prior from a chunk's
    candidate rows: broadcast the (ppc, 10) rows across the pixel's spp
    lanes and MT each lane's (subpixel) ray against its pixel's candidate.
    A candidate hit is a genuine scene hit, so t0 bounds the closest t even
    if the row were misaligned with the pixel (padded tail chunks) — the
    bound is then merely less tight, never wrong."""
    m = ray.o.shape[0]
    ppc = prior_rows_c.shape[0]
    pr = jnp.broadcast_to(prior_rows_c[:, None, :],
                          (ppc, spp, 10)).reshape(m, 10)
    o, d = sg(ray.o), sg(ray.d)
    uv_c, t_c = ray_intersect_triangle(pr[:, 0:3], pr[:, 3:6], pr[:, 6:9],
                                       o, d)
    cand_tri = pr[:, 9].astype(jnp.int32)
    ok = ((uv_c[:, 0] >= 0.0) & (uv_c[:, 1] >= 0.0)
          & (uv_c[:, 0] + uv_c[:, 1] <= 1.0) & (t_c > RayEpsilon)
          & (t_c < 1e30) & (cand_tri >= 0))
    # margin covers last-ulp disagreement between this MT and the kernel's;
    # a too-generous bound only costs cull efficiency, never correctness
    tmax_b = jnp.where(ok, t_c * 1.001 + 1e-4, jnp.inf)
    return (tmax_b, cand_tri, jnp.where(ok[..., None], uv_c, 0.0),
            jnp.where(ok, t_c, jnp.inf), ok)


def tiled_pixel_order(width: int, height: int, tile: int = 32) -> np.ndarray:
    """Pixel ids in tile-major traversal order. Lanes that are adjacent in
    the wavefront then form tight ray frusta, which is what makes the
    block-culled intersection backend effective (accel/bvh.py) — scanline
    order would spread each ray block across the whole viewport."""
    yy, xx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    order = np.lexsort((xx.ravel() % tile, yy.ravel() % tile,
                        xx.ravel() // tile, yy.ravel() // tile))
    return (yy.ravel() * width + xx.ravel())[order].astype(np.int32)


def tile_pos_to_pixel(pos: jax.Array, width: int, height: int,
                      tile: int = 32):
    """Closed-form inverse of ``tiled_pixel_order`` when the film tiles
    evenly: pixel id at tile-traversal position ``pos`` by pure integer
    arithmetic — the wavefront-sized ``pix_order[...]`` gather becomes
    integer math. Returns None when width/height don't tile evenly (callers
    fall back to the table gather)."""
    if width % tile or height % tile:
        return None
    tiles_x = width // tile
    within = pos % (tile * tile)
    t = pos // (tile * tile)
    y = (t // tiles_x) * tile + within // tile
    x = (t % tiles_x) * tile + within % tile
    return y * width + x


def accumulate_image(value: jax.Array, pixel_idx: jax.Array,
                     num_pixels: int) -> jax.Array:
    """Scatter-add sample values into a (num_pixels, 3) image; lanes with
    pixel_idx < 0 are dropped (extra overflow bucket)."""
    idx = jnp.where(pixel_idx >= 0, pixel_idx, num_pixels)
    img = jax.ops.segment_sum(value, idx, num_segments=num_pixels + 1)
    return img[:num_pixels]


def scan_lane_chunks(run_lanes, n: int, num_pixels: int, key: jax.Array,
                     pass_lanes: int, lane_range=None,
                     remat: bool = False) -> jax.Array:
    """Run ``run_lanes(lane (m,), key) -> (num_pixels, 3) partial image``
    over the wavefront in bounded passes (in-jit lax.scan), summing images.
    Caps XLA HLO-temp memory on huge wavefronts (see RenderOptions.pass_lanes).

    ``lane_range=(start, count)`` restricts the sweep to a slice of the lane
    domain (multi-chip lane sharding; ``start`` may be traced, ``count`` must
    be static). Lanes >= n are masked inside ``run_lanes``.

    ``remat=True`` checkpoints each pass: under ``grad`` the backward then
    recomputes the pass forward instead of spilling every chunk's residual
    intermediates (dozens of wavefront-sized arrays per chunk) to HBM —
    the classic renderer trade (recompute is compute-cheap, residual IO is
    bandwidth-expensive).
    """
    start, count = (0, n) if lane_range is None else lane_range
    chunk = min(pass_lanes, count)
    n_chunks = -(-count // chunk)
    if remat:
        run_lanes = jax.checkpoint(run_lanes)
    if n_chunks == 1:
        return run_lanes(start + jnp.arange(count, dtype=jnp.int32), key)
    keys = jax.random.split(key, n_chunks)

    def body(acc, args):
        c, key_c = args
        lane = start + c * chunk + jnp.arange(chunk, dtype=jnp.int32)
        return acc + run_lanes(lane, key_c), None

    img, _ = jax.lax.scan(body, jnp.zeros((num_pixels, 3), jnp.float32),
                          (jnp.arange(n_chunks), keys))
    return img


def shard_lane_range(n: int, shard) -> tuple:
    """Contiguous lane slice for device ``d`` of ``n_dev`` covering [0, n):
    ``shard=(d, n_dev)`` -> (start, count). Each device gets ceil(n/n_dev)
    lanes; the overflow tail is masked by the usual ``lane < n`` guards, so
    summing the per-device partial images reproduces the full-budget
    estimator exactly for any n."""
    d, n_dev = shard
    count = -(-n // n_dev)
    return d * count, count


class Integrator:
    """Base class; subclasses implement Li(scene, flat, rng, ray, active).

    ``prior`` is the optional camera-hit prior for the first (camera)
    closest hit — a pure performance hint; implementations route it through
    ``ray_intersect_with_prior`` (exactness preserved) or ignore it."""

    def Li(self, scene: Scene, flat: FlatScene, rng: RngStream, ray,
           active, prior=None) -> jax.Array:
        raise NotImplementedError

    # -- interior -------------------------------------------------------------
    def render_interior(self, scene: Scene, flat: FlatScene, sensor_id: int,
                        key: jax.Array, shard=None) -> jax.Array:
        opts = scene.opts
        num_pixels = opts.num_pixels
        spp = opts.spp
        if spp == 0:
            return jnp.zeros((num_pixels, 3), jnp.float32)
        n = num_pixels * spp
        # tile-ordered pixels: consecutive lanes -> coherent ray blocks
        pix_order_np = tiled_pixel_order(opts.width, opts.height)
        pix_order = jnp.asarray(pix_order_np)

        # stratify the subpixel jitter over an a x b grid when spp
        # factorizes (beyond-reference: psdr-cuda samples independently);
        # lower primary-visibility variance at identical cost
        a = int(np.sqrt(spp))
        while a > 1 and spp % a:
            a -= 1
        use_sobol = opts.sampler == "sobol" and spp > 1
        use_strat = (opts.stratify_primary and opts.sampler == "stratified"
                     and a > 1)
        strat = (a, spp // a) if use_strat else None

        # pixel-aligned chunking (every chunk holds whole pixels) is what
        # makes per-pixel stratum reshapes valid downstream (NEE
        # visibility reuse, direct.py _nee_visibility). The shard start
        # may be a TRACED device index * count — alignment must be decided
        # statically, and start = d*count is spp-aligned for every d iff
        # count is.
        start0, count0 = (0, n) if shard is None else shard_lane_range(n, shard)
        start_ok = (start0 % spp == 0 if isinstance(start0, int)
                    else count0 % spp == 0)
        vis_aligned = (min(opts.pass_lanes, count0) % spp == 0
                       and count0 % spp == 0 and start_ok)

        def lane_values(lane, key_c, prior_rows_c=None):
            pos = jnp.minimum(lane // spp, num_pixels - 1)
            idx_arith = tile_pos_to_pixel(pos, opts.width, opts.height)
            idx = pix_order[pos] if idx_arith is None else idx_arith
            base = jnp.stack([(idx % opts.width).astype(jnp.float32),
                              (idx // opts.width).astype(jnp.float32)],
                             axis=-1)
            rng = RngStream(key_c, salt=0)
            if vis_aligned:
                rng.vis_spp = spp
            m = lane.shape[0]
            jitter = rng.next_2d(m)
            if use_sobol:
                # XOR-scrambled (0,2)-sequence: subpixel jitter +
                # downstream first NEE/BSDF samples each get an
                # independent per-pixel scramble pair (randomized QMC)
                from ..core.sampler import ld_2d
                w = jax.random.randint(rng._subkey(), (6,), 0, jnp.iinfo(
                    jnp.int32).max, jnp.int32).astype(jnp.uint32)

                def pix_scramble(word):
                    h = idx.astype(jnp.uint32) ^ word
                    h = (h ^ (h >> 16)) * jnp.uint32(0x45D9F3B)
                    h = (h ^ (h >> 16)) * jnp.uint32(0x45D9F3B)
                    return h ^ (h >> 16)

                s_idx = (lane % spp).astype(jnp.uint32)
                jitter = ld_2d(s_idx, pix_scramble(w[0]), pix_scramble(w[1]))
                rng.ld = (s_idx, pix_scramble(w[2]), pix_scramble(w[3]),
                          pix_scramble(w[4]), pix_scramble(w[5]))
            if strat is not None:
                sa, sb = strat
                s_idx = lane % spp
                cell = jnp.stack([(s_idx % sa).astype(jnp.float32),
                                  (s_idx // sa).astype(jnp.float32)],
                                 axis=-1)
                jitter = (cell + jitter) / jnp.array([sa, sb], jnp.float32)
                # per-pixel rotated stratum index for downstream samples
                # (NEE): each pixel rotates its strata by an independent
                # hash so subpixel and light strata decorrelate across
                # pixels ("padded" stratified sampling)
                w = jax.random.randint(rng._subkey(), (2,), 0, jnp.iinfo(
                    jnp.int32).max, jnp.int32).astype(jnp.uint32)

                def pix_hash(word):
                    h = idx.astype(jnp.uint32) ^ word
                    h = (h ^ (h >> 16)) * jnp.uint32(0x45D9F3B)
                    h = (h ^ (h >> 16)) * jnp.uint32(0x45D9F3B)
                    return ((h ^ (h >> 16))
                            % jnp.uint32(spp)).astype(jnp.int32)

                # independent per-pixel rotations for the NEE and BSDF
                # consumers so their stratum alignments decorrelate; the
                # (sa, sb) grid rides along so _stratify2 shares THIS
                # factorization instead of re-deriving one
                rng.strata = (s_idx, spp, (sa, sb),
                              pix_hash(w[0]), pix_hash(w[1]))
            samples = (base + jitter) / jnp.array(
                [opts.width, opts.height], jnp.float32)
            ray = sample_primary_ray(flat.sensors[sensor_id], samples)
            # kwarg only when a prior exists: ad-hoc Li overrides (probe
            # scripts) need not declare the parameter
            if prior_rows_c is None:
                value = self.Li(scene, flat, rng, ray, lane < n)
            else:
                prior = camera_prior_for_rays(prior_rows_c, ray, spp)
                value = self.Li(scene, flat, rng, ray, lane < n, prior=prior)
            value = scrub_nonfinite(value)
            return jnp.where((lane < n)[..., None], value, 0.0), idx

        start, count = (0, n) if shard is None else shard_lane_range(n, shard)
        chunk = min(opts.pass_lanes, count)

        if chunk % spp == 0 and count % spp == 0:
            # interior lanes are pixel-major: lane // spp walks pix_order
            # contiguously, so each chunk reduces to a dense (chunk/spp, 3)
            # block written at a static-stride offset — no 2M-lane
            # scatter-add per pass, just a reshape-sum + one final gather
            # from tile order back to pixel order
            ppc = chunk // spp
            n_chunks = -(-count // chunk)
            # camera-hit prior: one detached pixel-center trace per frame;
            # each chunk slices its pixels' candidate rows contiguously
            prior_rows = None
            if opts.resolve_camera_prior(spp) and flat.face_table is not None:
                prior_rows = camera_prior_rows(flat, sensor_id, pix_order,
                                               opts)

            def chunk_block(c, key_c):
                lane = start + c * chunk + jnp.arange(chunk, dtype=jnp.int32)
                pr_c = None
                if prior_rows is not None:
                    pr_c = jax.lax.dynamic_slice(
                        prior_rows, (start // spp + c * ppc, 0), (ppc, 10))
                value, _ = lane_values(lane, key_c, pr_c)
                return value.reshape(ppc, spp, 3).sum(axis=1)

            if opts.resolve_remat(count):
                # see scan_lane_chunks: trade backward residual IO for a
                # forward recompute of each pass chunk
                chunk_block = jax.checkpoint(chunk_block)

            if n_chunks == 1:
                tile_img = chunk_block(jnp.int32(0), key)
            else:
                keys = jax.random.split(key, n_chunks)

                def body(acc, args):
                    c, key_c = args
                    acc = jax.lax.dynamic_update_slice(
                        acc, chunk_block(c, key_c), (c * ppc, 0))
                    return acc, None

                tile_img, _ = jax.lax.scan(
                    body, jnp.zeros((n_chunks * ppc, 3), jnp.float32),
                    (jnp.arange(n_chunks), keys))
            # pixel p sits at tile position inv_order[p]; this device's
            # block covers positions [start/spp, start/spp + rows)
            inv_order = jnp.asarray(np.argsort(pix_order_np).astype(np.int32))
            rows = tile_img.shape[0]
            rel = inv_order - start // spp
            in_range = (rel >= 0) & (rel < rows)
            img = jnp.where(in_range[..., None],
                            tile_img[jnp.clip(rel, 0, rows - 1)], 0.0)
            return img / spp

        def run_lanes(lane, key_c):
            value, idx = lane_values(lane, key_c)
            return accumulate_image(value,
                                    jnp.where(lane < n, idx, -1), num_pixels)

        img = scan_lane_chunks(run_lanes, n, num_pixels, key, opts.pass_lanes,
                               shard and shard_lane_range(n, shard),
                               remat=opts.resolve_remat(count))
        return img / spp

    # -- primary boundary ------------------------------------------------------
    def render_primary_edges(self, scene: Scene, flat: FlatScene,
                             sensor_id: int, key: jax.Array,
                             shard=None) -> jax.Array:
        opts = scene.opts
        num_pixels = opts.num_pixels
        sensor = flat.sensors[sensor_id]
        if opts.sppe == 0 or sensor.edges is None:
            return jnp.zeros((num_pixels, 3), jnp.float32)
        n = num_pixels * opts.sppe
        from ..scene.scene import detach_flat
        flat_det = detach_flat(flat)

        def run_lanes(lane, key_c):
            rng = RngStream(key_c, salt=1)
            m = lane.shape[0]
            # edge-sorted lanes are spatially coherent, so the NEE
            # visibility-reuse machinery applies with G consecutive lanes
            # playing the role of a pixel's strata (direct.py
            # _nee_visibility is grouping-agnostic: the control variate is
            # unbiased for ANY group partition; variance depends only on
            # within-group correlation). Both concatenated +/- halves
            # group independently since G divides m.
            if m % 16 == 0 and os.environ.get(
                    "PSDR_TPU_VIS_REUSE", "edge") == "edge":
                rng.vis_spp = 16
            pes = sample_primary_edge(sensor, jnp.sort(rng.next_1d(m)))
            valid = (pes.idx >= 0) & (lane < n)
            if opts.primary_edge_vis_check:
                # reject samples whose edge point is occluded from the
                # camera (integrator.cpp:104-106 under the vis-check macro)
                from ..scene.scene import ray_test
                occluded = ray_test(flat_det, pes.ray_c, pes.vis_dist, valid)
                valid = valid & ~occluded
            # ONE Li over the concatenated +/- rays instead of two calls:
            # the per-call trace sets (closest hit, NEE sampling + sweep,
            # emitter-first bounce) then amortize their fixed per-block
            # costs across both sides; lanes stay edge-sorted within each
            # half. Statistically identical (both sides drew independent
            # streams before too).
            m2 = pes.ray_n.o.shape[0]
            rays_cat = jax.tree.map(
                lambda a, b: jnp.concatenate([a, b]), pes.ray_n, pes.ray_p)
            L = sg(self.Li(scene, flat_det, rng, rays_cat,
                           jnp.concatenate([valid, valid])))
            delta_L = L[:m2] - L[m2:]
            pdf = jnp.where(valid, sg(pes.pdf), 1.0)
            value = pes.x_dot_n[..., None] * (delta_L / pdf[..., None])
            value = scrub_nonfinite(value)
            if opts.sppe > 1:
                value = value / opts.sppe
            value = value - sg(value)
            value = jnp.where(valid[..., None], value, 0.0)
            return accumulate_image(value, jnp.where(valid, pes.idx, -1),
                                    num_pixels)

        lane_range = shard and shard_lane_range(n, shard)
        # halved chunk: run_lanes doubles its lane count internally (the
        # concatenated +/- rays), keeping HLO temporaries at pass_lanes
        return scan_lane_chunks(run_lanes, n, num_pixels, key,
                                max(1, opts.pass_lanes // 2), lane_range,
                                remat=opts.resolve_remat(
                                    n if lane_range is None else lane_range[1]))

    # -- secondary boundary: overridden by integrators that support it ---------
    def render_secondary_edges(self, scene: Scene, flat: FlatScene,
                               sensor_id: int, key: jax.Array,
                               shard=None) -> jax.Array:
        return jnp.zeros((scene.opts.num_pixels, 3), jnp.float32)

    # -- public API -------------------------------------------------------------
    def radiance_image(self, scene: Scene, flat: FlatScene, sensor_id: int,
                       key: jax.Array, with_boundary: bool,
                       shard=None) -> jax.Array:
        """Full differentiable render: interior + boundary terms.
        Returns (num_pixels, 3); reshape to (H, W, 3) for display.

        ``shard=(device_index, n_devices)`` restricts every term to that
        device's lane slice (parallel/sharding.py lane-DP); the per-device
        partial images then *sum* (psum) to the full-budget estimator.
        """
        keys = jax.random.split(key, 3)
        img = self.render_interior(scene, flat, sensor_id, keys[0], shard)
        if with_boundary and scene.opts.sppe > 0:
            img = img + self.render_primary_edges(scene, flat, sensor_id,
                                                  keys[1], shard)
        if with_boundary and scene.opts.sppse > 0:
            img = img + self.render_secondary_edges(scene, flat, sensor_id,
                                                    keys[2], shard)
        return img

    def render_fn(self, scene: Scene, sensor_id: int = 0,
                  with_boundary: bool = True, detached: bool = False):
        """A jittable, differentiable ``f(params, key) -> (num_pixels, 3)``
        that rebuilds the scene from params (AD flows through configure,
        matching the reference's re-configure-per-iteration loop).

        ``detached=True`` returns a pure forward renderer (renderC
        semantics with per-frame rebuild): gradients are stopped after
        build, so the hit recompute takes its fast path — use for forward
        throughput and preview renders, never under ``grad``."""
        scene.prepare_accel()
        from ..scene.scene import detach_flat

        def f(params, key):
            flat = scene.build(params)
            if detached:
                flat = detach_flat(flat)
            return self.radiance_image(scene, flat, sensor_id, key, with_boundary)
        return f

    def _jit_radiance(self, scene: Scene, sensor_id: int,
                      with_boundary: bool):
        """Per-integrator jit cache: an eager radiance_image dispatches
        hundreds of individual ops — renderC/renderD route through
        one compiled program per (scene, flat, opts, sensor, boundary)
        combo instead."""
        cache = getattr(self, "_radiance_jits", None)
        if cache is None:
            cache = self._radiance_jits = {}
        return cache

    def _jit_radiance_call(self, scene, sensor_id, with_boundary,
                           detached, key):
        cache = self._jit_radiance(scene, sensor_id, with_boundary)
        from ..scene.scene import detach_flat
        flat = scene.flat
        # the FlatScene mixes arrays with static fields, so it is closed
        # over (arrays become hoisted constants) rather than passed as an
        # argument; the cache key tracks its identity and detaching
        # happens inside the traced function (a fresh detach_flat pytree
        # per call would defeat the cache)
        k = (id(scene), id(flat), scene.opts, sensor_id, with_boundary,
             detached)
        f = cache.get(k)
        if f is None:
            if len(cache) > 16:
                cache.clear()

            def run(key_):
                fl = detach_flat(flat) if detached else flat
                return self.radiance_image(scene, fl, sensor_id, key_,
                                           with_boundary)

            f = cache[k] = jax.jit(run)
        return f(key)

    def renderC(self, scene: Scene, sensor_id: int = 0, seed: int = 0) -> jax.Array:
        """Forward render at current params -> (H, W, 3)."""
        img = self._jit_radiance_call(scene, sensor_id, False, True,
                                      jax.random.PRNGKey(seed))
        return img.reshape(scene.opts.height, scene.opts.width, 3)

    def renderD(self, scene: Scene, sensor_id: int = 0, seed: int = 0) -> jax.Array:
        """Primal of the differentiable render (boundary terms are zero in
        the primal by construction) -> (H, W, 3)."""
        img = self._jit_radiance_call(scene, sensor_id, True, False,
                                      jax.random.PRNGKey(seed))
        return img.reshape(scene.opts.height, scene.opts.width, 3)
