"""Depth-N path tracer with next-event estimation and MIS.

The reference repository ships only a one-bounce DirectIntegrator
(src/integrator/direct.cpp); its successors add a PathTracer. This is the
multi-bounce interior estimator (BASELINE.json config 2: "path tracer
depth=3"): per bounce one NEE (light) sample and one BSDF continuation
sample, combined with the power-2 MIS heuristic exactly as
direct.cpp:17-21/46-163 does for a single bounce, generalized by carrying a
path throughput. The AD structure mirrors the reference's: BSDF-sampled
hits are converted to area measure with a *detached* geometry factor
(direct.cpp:83-95) and multiplied by the reparameterization Jacobian J of
each hit, so interior gradients of vertex positions flow through the
differentiable hit recompute at every bounce.

Shape: the bounce loop is a static Python unroll inside jit (static
depth, no dynamic control flow); every lane stays live with masks — dead
lanes carry zero throughput, which XLA handles better than compaction.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from ..accel.bruteforce import HitRecord
from ..bsdf import (all_reflective_one_sided, eval_bsdf, pdf_bsdf,
                    sample_bsdf)
from ..core.constants import ShadowEpsilon
from ..core.frame import to_local, to_world
from ..core.math import dot, sqr, squared_norm
from ..core.records import Ray
from ..core.sampler import RngStream
from ..scene.scene import (FlatScene, Scene, detach_flat, emitter_position_pdf,
                           ray_intersect, ray_intersect_emitter_first,
                           ray_intersect_with_prior, ray_test,
                           sample_emitter_position, scene_le, select_rows)
from .base import Integrator
from .direct import (DirectIntegrator, _compact_boundary_lanes,
                     _compact_eligibility, _emitter_meta, _mdiv, _stratify2)

sg = jax.lax.stop_gradient


def _direction_segment_valid(flat_det, sample3):
    """Detached silhouette validity of direction-sampled boundary lanes —
    the sampling pre-pass twin of eval_secondary_edge_indirect /
    eval_secondary_edge_camera(far="direction"); must stay in lockstep
    with their edge/direction draws. ONE packed (E, 9) row gather for the
    four fields it reads (wavefront-sized separate gathers cost more
    than one packed row gather)."""
    from ..core import warp as warp_mod
    from ..core.constants import EdgeEpsilon
    from ..core.distribution import discrete_sample_reuse
    from ..core.math import sign_eps
    edge_idx, _, _ = discrete_sample_reuse(flat_det.sec_distrb,
                                           sample3[..., 0])
    se = flat_det.sec_edge
    packed = jnp.concatenate(
        [se.n0, se.n1, se.valid.astype(jnp.float32)[:, None],
         se.is_boundary.astype(jnp.float32)[:, None],
         flat_det.sec_distrb.pmf[:, None]], axis=1)[edge_idx]
    ok = (packed[:, 6] > 0.5) & (packed[:, 8] > 0.0)
    d = warp_mod.square_to_uniform_sphere(sample3[..., 1:3])
    s0 = sign_eps(dot(packed[:, 0:3], d), EdgeEpsilon)
    s1 = sign_eps(dot(packed[:, 3:6], d), EdgeEpsilon)
    return ok & jnp.where(packed[:, 7] > 0.5, s0 != 0, s0 * s1 < 0)


class PathTracer(Integrator):
    """Unidirectional path tracer: NEE + BSDF sampling with MIS per bounce.

    ``max_depth`` counts segments: 1 reproduces DirectIntegrator's
    estimator (camera hit + one bounce of lighting).
    """

    def __init__(self, max_depth: int = 3, hide_emitters: bool = False,
                 camera_depth: int = 1, scan_depths: bool | None = None):
        """``camera_depth`` >= 2 adds the camera-side indirect boundary
        estimators: discontinuities whose receiver point is seen through
        up to camera_depth-1 extra bounces (BASELINE config 4).

        ``scan_depths``: run the middle bounces (neither the stratified
        first nor the emitter-first last) as one ``lax.scan`` iteration
        instead of Python-unrolling them — the traced program stays O(1)
        in max_depth (deep paths would otherwise multiply the compile
        time). None = auto: scan when >= 4 middle depths.
        Unrolled and scanned modes draw identical per-depth subkeys, so
        they produce the same image (tests/test_path.py)."""
        assert max_depth >= 1 and camera_depth >= 1
        self.max_depth = max_depth
        self.hide_emitters = hide_emitters
        self.camera_depth = camera_depth
        self.scan_depths = scan_depths
        self.warpper: dict[int, object] = {}
        self.ind_warpper: dict[int, object] = {}

    def Li(self, scene: Scene, flat: FlatScene, rng: RngStream, ray: Ray,
           active: jax.Array, prior=None) -> jax.Array:
        kinds = scene.bsdf_kinds
        emeta = _emitter_meta(scene)
        offsets = scene.face_offset
        n = ray.o.shape[0]

        # tmax-bounded when the interior pass attached a camera-hit prior
        # (exact — see ray_intersect_with_prior)
        its = ray_intersect_with_prior(flat, ray, active, prior)
        active = active & its.valid

        result = (jnp.zeros((n, 3), jnp.float32) if self.hide_emitters
                  else scene_le(flat, its, active))
        beta = jnp.ones((n, 3), jnp.float32)  # path throughput
        if flat.envmap is not None:
            active = active & (its.bsdf_id >= 0)

        # every per-depth draw folds (depth, draw-id) from one subkey, so
        # the unrolled and lax.scan depth loops consume identical samples
        depth_base = rng._subkey()

        def depth_body(state, kd, first: bool, last: bool):
            its, beta, active, result = state
            # --- NEE via occlusion test (tmax-pruned; see direct.py) ---
            u2 = jax.random.uniform(jax.random.fold_in(kd, 0), (n, 2))
            if first:
                # first-bounce NEE/BSDF samples ride the pixel's rotated
                # spp strata (stratify_primary; see direct._stratify2)
                u2 = _stratify2(u2, rng, which=0)
            ps = sample_emitter_position(flat, offsets, emeta, its.p,
                                         u2, active)
            active_l = active & ps.valid

            wo = ps.p - its.p
            dist_sqr = squared_norm(wo)
            dist = jnp.sqrt(jnp.maximum(dist_sqr, 1e-20))
            wo = wo / dist[..., None]

            # zero-contribution side gates BEFORE the occlusion trace
            # (see DirectIntegrator Li: a back-facing emitter sample
            # contributes nothing; the below-horizon gates apply only when
            # every scene BSDF is reflective one-sided — capability flag
            # in bsdf/__init__.py. Exact, pinned by renderC tests)
            cos_l = dot(ps.n, -wo)
            is_env = ps.emitter < 0
            active_l = active_l & (is_env | (cos_l > 0.0))
            if all_reflective_one_sided(kinds):
                active_l = (active_l
                            & (sg(to_local(its.sh_frame, wo))[..., 2] > 0.0)
                            & (sg(its.wi)[..., 2] > 0.0))
            # NEE visibility reuse at the first bounce (camera hits are
            # pixel-coherent; later bounces decorrelate) — see
            # DirectIntegrator._nee_visibility; falls back to the plain
            # tmax-pruned sweep
            vis = None
            if first:
                vis = DirectIntegrator._nee_visibility_impl(
                    flat, rng, its.p, wo, dist, active_l, n,
                    light_samples=1)
            if vis is None:
                # sort envmap-sampled shadow directions (DirectIntegrator)
                occluded = ray_test(flat, Ray(its.p, wo), dist, active_l,
                                    sort_rays=flat.envmap is not None)
                active_l = active_l & ~occluded
            else:
                active_l = active_l & (vis != 0.0)

            le = jnp.where((ps.emitter >= 0)[..., None],
                           select_rows(flat.emitter_radiance,
                                       jnp.maximum(ps.emitter, 0)),
                           0.0)
            if flat.envmap is not None:
                from ..emitter.envmap import envmap_eval_direction
                le = jnp.where(is_env[..., None],
                               envmap_eval_direction(flat.envmap, wo,
                                                     active_l & is_env), le)

            G_l = _mdiv(jnp.abs(cos_l), dist_sqr, active_l)
            wo_local = to_local(its.sh_frame, wo)
            f_l = eval_bsdf(kinds, flat.bsdfs, its, wo_local, active_l)
            pdf_b = pdf_bsdf(kinds, flat.bsdfs, its, wo_local, active_l)
            f_l = f_l * _mdiv(G_l * ps.J, ps.pdf, active_l)[..., None]
            pdf_b_area = pdf_b * sg(G_l)

            w_den = sqr(ps.pdf) + sqr(pdf_b_area)
            w_l = _mdiv(sqr(ps.pdf), w_den, active_l & (w_den > 0.0))
            contrib = le * f_l * w_l[..., None]
            if vis is not None:
                contrib = contrib * vis[..., None]
            result = result + jnp.where(active_l[..., None],
                                        beta * contrib, 0.0)

            # --- BSDF continuation (direct.cpp:64-114 pattern) ---
            u3 = jax.random.uniform(jax.random.fold_in(kd, 1), (n, 3))
            if first:
                u3 = u3.at[:, 0:2].set(_stratify2(u3[:, 0:2], rng, which=1))
            bs = sample_bsdf(kinds, flat.bsdfs, its, u3, active)
            active_b = active & bs.valid

            ray_b = Ray(its.p, to_world(its.sh_frame, bs.wo))
            if last and flat.em_tri_idx is not None:
                # the final bounce has no continuation: only the MIS-
                # weighted emitter hit consumes its_b, so the full-scene
                # closest hit reduces to emitter-hit + occlusion (direct.py)
                its_b = ray_intersect_emitter_first(flat, ray_b, active_b)
            else:
                its_b = ray_intersect(flat, ray_b, active_b, path_space=True,
                                      sort_rays=True)
            hit_b = active_b & its_b.valid

            wo_b = its_b.p - its.p
            wo_b = _mdiv(wo_b, its_b.t, hit_b)
            f_b = eval_bsdf(kinds, flat.bsdfs, its,
                            to_local(its.sh_frame, wo_b), hit_b)
            cos_b = dot(its_b.n, -wo_b)
            G_b = _mdiv(jnp.abs(cos_b), sqr(its_b.t), hit_b)
            pdf0 = bs.pdf * sg(G_b)
            # throughput update: f * G * J / pdf (area measure)
            w_path = _mdiv(G_b * its_b.J, pdf0, hit_b & (pdf0 > 0.0))
            f_over_pdf = f_b * w_path[..., None]

            # emitter hit along the BSDF ray -> MIS-weighted emission
            hit_em = hit_b & its_b.is_emitter()
            pdf_nee = emitter_position_pdf(flat, emeta, its.p, its_b, hit_em)
            w_den_b = sqr(pdf0) + sqr(pdf_nee)
            w_b = _mdiv(sqr(pdf0), w_den_b, hit_em & (w_den_b > 0.0))
            contrib_b = scene_le(flat, its_b, hit_em) * f_over_pdf * w_b[..., None]
            result = result + jnp.where(hit_em[..., None],
                                        beta * contrib_b, 0.0)

            # advance the path (dead on the last bounce; with emitter-first
            # its_b is then only valid on emitter lanes and must not feed a
            # continuation)
            if not last:
                beta = jnp.where(hit_b[..., None], beta * f_over_pdf, 0.0)
                active = hit_b & (its_b.bsdf_id >= 0) & jnp.any(beta > 0.0, -1)
                its = its_b
            return its, beta, active, result

        D = self.max_depth
        state = (its, beta, active, result)
        state = depth_body(state, jax.random.fold_in(depth_base, 0),
                           first=True, last=(D == 1))
        n_mid = D - 2  # depths 1 .. D-2: uniform body, scannable
        if n_mid > 0:
            use_scan = (self.scan_depths if self.scan_depths is not None
                        else n_mid >= 4)
            if use_scan:
                keys = jax.vmap(
                    lambda i: jax.random.fold_in(depth_base, i))(
                        jnp.arange(1, D - 1))
                state = jax.lax.scan(
                    lambda st, kd: (depth_body(st, kd, False, False), None),
                    state, keys)[0]
            else:
                for d in range(1, D - 1):
                    state = depth_body(
                        state, jax.random.fold_in(depth_base, d),
                        first=False, last=False)
        if D >= 2:
            state = depth_body(state, jax.random.fold_in(depth_base, D - 1),
                               first=False, last=True)
        return state[3]

    # -- boundary terms ------------------------------------------------------
    # The *direct* boundary estimator (emitter-sampled far side) applies
    # unchanged. The *indirect* estimator below goes beyond the reference
    # (its successors add it): it samples a direction at the edge instead of
    # an emitter point, finds the far-side surface, and uses a detached
    # multi-bounce radiance estimate excluding that surface's own emission
    # (which the direct estimator already covers) — capturing visibility
    # discontinuities of indirectly-lit shadows.
    def render_secondary_edges(self, scene, flat, sensor_id, key,
                               shard=None):
        # Fused boundary passes: when the
        # camera-side estimators are active, each far-side kind runs ONE
        # scan in which the s=1 and s>=2 estimators share the sample
        # stream, detached validity pre-pass, compaction, far trace (+ the
        # detached walk L for the direction side — the most expensive
        # piece), anchor trace, and edge-local kernel. Sharing samples
        # across estimator terms correlates them but the sum stays
        # unbiased (expectation is linear). Falls back to the separate
        # per-estimator passes when a sub-pass is instance-monkeypatched
        # (test seam) or PSDR_TPU_FUSED_BOUNDARY=0.
        fused = (self.camera_depth > 1
                 and "render_camera_edges" not in self.__dict__
                 and "render_indirect_edges" not in self.__dict__
                 and os.environ.get("PSDR_TPU_FUSED_BOUNDARY", "1") == "1")
        if fused:
            img = self._render_boundary_fused(scene, flat, sensor_id, key,
                                              "emitter", shard)
            if self.max_depth > 1:
                img = img + self._render_boundary_fused(
                    scene, flat, sensor_id, jax.random.fold_in(key, 7),
                    "direction", shard)
            return img
        helper = DirectIntegrator(1, 1)
        helper.warpper = self.warpper
        img = helper.render_secondary_edges(scene, flat, sensor_id, key, shard)
        if self.max_depth > 1:
            img = img + self.render_indirect_edges(scene, flat, sensor_id,
                                                   jax.random.fold_in(key, 7),
                                                   shard)
        if self.camera_depth > 1:
            # sensor-subpath estimators: (s>=2, t=1) and (s>=2, t>=2)
            img = img + self.render_camera_edges(
                scene, flat, sensor_id, jax.random.fold_in(key, 11), "emitter",
                shard)
            if self.max_depth > 1:
                img = img + self.render_camera_edges(
                    scene, flat, sensor_id, jax.random.fold_in(key, 13),
                    "direction", shard)
        return img

    def _render_boundary_fused(self, scene: Scene, flat: FlatScene,
                               sensor_id: int, key: jax.Array, far: str,
                               shard=None) -> jax.Array:
        """One scan per far-side kind covering BOTH the s=1 estimator
        (direct secondary / indirect) and the s>=2 camera-side walk.

        Guiding: the s=1 guiding table also warps the shared stream. Cells
        whose s=1 |value| mass is zero can still carry s>=2 contributions
        (a receiver hidden from the camera is exactly the camera-side
        term's signal), so the warp gets a defensive uniform floor — any
        density > 0 on the integrand's support keeps both terms unbiased;
        the floor only dilutes the s=1 guiding slightly."""
        from ..core.distribution import (hypercube_sample_reuse,
                                         hypercube_set_mass)
        from ..core.math import scrub_nonfinite
        from ..core.constants import Epsilon
        from .base import accumulate_image, scan_lane_chunks, shard_lane_range

        opts = scene.opts
        num_pixels = opts.num_pixels
        n = num_pixels * opts.sppse

        warp = (self.warpper if far == "emitter" else self.ind_warpper).get(
            sensor_id)
        if warp is not None:
            pmf = warp.distrb.pmf
            warp = hypercube_set_mass(
                warp, pmf + 0.1 * jnp.mean(pmf))
        flat_det = detach_flat(flat)
        emeta = _emitter_meta(scene)

        def eval_tail(sample3_t, pdf0_t, live_t, rng, weight_t=None):
            splats = self.eval_secondary_edge_camera(
                scene, flat, sensor_id, sample3_t, rng, far, include_s1=True)
            img = jnp.zeros((num_pixels, 3), jnp.float32)
            for pix, value in splats:
                value = scrub_nonfinite(value)
                value = jnp.where(
                    (pdf0_t > Epsilon)[..., None],
                    value / jnp.where(pdf0_t > Epsilon, pdf0_t,
                                      1.0)[..., None],
                    value)
                if weight_t is not None:
                    value = value * weight_t[..., None]
                if opts.sppse > 1:
                    value = value / opts.sppse
                img = img + accumulate_image(
                    jnp.where(live_t[..., None], value, 0.0),
                    jnp.where(live_t, pix, -1), num_pixels)
            return img

        def run_lanes(lane, key_c):
            rng = RngStream(key_c, salt=2 if far == "emitter" else 3)
            m = lane.shape[0]
            sample3 = rng.next_3d(m)
            sample3 = sample3[jnp.argsort(sample3[:, 0])]
            if warp is not None:
                sample3, pdf0 = hypercube_sample_reuse(warp, sample3)
            else:
                pdf0 = jnp.ones((m,), jnp.float32)
            live = lane < n
            elig = _compact_eligibility(m, guided=warp is not None)
            if elig is None:
                return eval_tail(sample3, pdf0, live, rng)
            s, ks = elig
            if far == "emitter":
                from ..scene.scene import sample_boundary_segment_direct
                v = sample_boundary_segment_direct(
                    flat_det, scene.face_offset, emeta, sg(sample3),
                    live).valid
            else:
                v = _direction_segment_valid(flat_det, sg(sample3))
            idx, weight, live_c = _compact_boundary_lanes(
                v & live, sample3[:, 0], rng.next_1d(m), s, ks)
            return eval_tail(sample3[idx], pdf0[idx], live_c, rng,
                             weight_t=weight)

        lane_range = shard and shard_lane_range(n, shard)
        return scan_lane_chunks(run_lanes, n, num_pixels, key,
                                opts.pass_lanes, lane_range,
                                remat=opts.resolve_remat(
                                    n if lane_range is None else lane_range[1]))

    def render_camera_edges(self, scene: Scene, flat: FlatScene,
                            sensor_id: int, key: jax.Array, far: str,
                            shard=None) -> jax.Array:
        """Boundary contributions whose receiver is seen through >= 1 extra
        bounce (sensor subpath length 2..camera_depth); each walk depth
        splats its own camera connection."""
        from ..core.math import scrub_nonfinite
        from .base import accumulate_image, scan_lane_chunks, shard_lane_range

        opts = scene.opts
        num_pixels = opts.num_pixels
        n = num_pixels * opts.sppse

        flat_det = detach_flat(flat)
        emeta = _emitter_meta(scene)

        def eval_tail(sample3_t, live_t, rng, weight_t=None):
            splats = self.eval_secondary_edge_camera(scene, flat, sensor_id,
                                                     sample3_t, rng, far)
            img = jnp.zeros((num_pixels, 3), jnp.float32)
            for pix, value in splats:
                value = scrub_nonfinite(value)
                if weight_t is not None:
                    # per-lane overflow re-weighting (count/ks; 1 when the
                    # segment's valid lanes all fit — the typical case)
                    value = value * weight_t[..., None]
                if opts.sppse > 1:
                    value = value / opts.sppse
                img = img + accumulate_image(
                    jnp.where(live_t[..., None], value, 0.0),
                    jnp.where(live_t, pix, -1), num_pixels)
            return img

        def run_lanes(lane, key_c):
            rng = RngStream(key_c, salt=5 if far == "emitter" else 6)
            m = lane.shape[0]
            sample3 = rng.next_3d(m)
            sample3 = sample3[jnp.argsort(sample3[:, 0])]
            live = lane < n
            elig = _compact_eligibility(m)
            if elig is None:
                return eval_tail(sample3, live, rng)
            s, ks = elig
            # both far sides are sparse (~3% valid lanes on cbox):
            # emitter side gated by the boundary-segment validity,
            # direction side by the silhouette condition
            if far == "emitter":
                from ..scene.scene import sample_boundary_segment_direct
                v = sample_boundary_segment_direct(
                    flat_det, scene.face_offset, emeta, sg(sample3),
                    live).valid
            else:
                v = _direction_segment_valid(flat_det, sg(sample3))
            idx, weight, live_c = _compact_boundary_lanes(
                v & live, sample3[:, 0], rng.next_1d(m), s, ks)
            return eval_tail(sample3[idx], live_c, rng, weight_t=weight)

        lane_range = shard and shard_lane_range(n, shard)
        return scan_lane_chunks(run_lanes, n, num_pixels, key,
                                opts.pass_lanes, lane_range,
                                remat=opts.resolve_remat(
                                    n if lane_range is None else lane_range[1]))

    def eval_secondary_edge_camera(self, scene: Scene, flat: FlatScene,
                                   sensor_id: int, sample3: jax.Array,
                                   rng: RngStream, far: str,
                                   include_s1: bool = False):
        """Sensor-subpath boundary estimator (s >= 2).

        Mirrors eval_secondary_edge's boundary-segment geometry
        (direct.cpp:224-316), but instead of requiring the receiver point
        p1 to be directly visible from the camera, it runs a *detached*
        importance walk from p1 (BSDF-sampled continuations with the
        adjoint shading-normal correction) and attempts a camera connection
        at each walk vertex q_k, k = 2..camera_depth — covering
        discontinuities seen through reflections. Depth-1 connections are
        intentionally absent (the s=1 estimators already cover them).

        ``far`` selects the light side: "emitter" = emitter-sampled p2 with
        full emission (t=1); "direction" = uniform-sphere direction with a
        detached reflected-only radiance estimate (t >= 2), mirroring
        eval_secondary_edge_indirect.

        Returns a list of (pixel_idx, value) splats, one per walk depth.
        """
        from ..bsdf import eval_bsdf
        from ..core import warp as warp_mod
        from ..core.constants import Epsilon, EdgeEpsilon, ShadowEpsilon
        from ..core.math import (bilinear, cross, norm, normalize,
                                 ray_intersect_triangle, sign_eps)
        from ..core.distribution import discrete_sample_reuse
        from ..scene.scene import sample_boundary_segment_direct
        from ..sensor.perspective import sample_direct, sample_primary_ray
        from ..shape.mesh import SecondaryEdgeInfo

        kinds = scene.bsdf_kinds
        emeta = _emitter_meta(scene)
        offsets = scene.face_offset
        sensor = flat.sensors[sensor_id]
        flat_det = detach_flat(flat)
        bsdfs_det = jax.tree.map(sg, flat.bsdfs)
        m = sample3.shape[0]

        if far == "emitter":
            bss = sample_boundary_segment_direct(flat, offsets, emeta,
                                                 sample3,
                                                 jnp.ones((m,), bool))
            valid = bss.valid
            p0, edge, edge2 = bss.p0, bss.edge, bss.edge2
            _p0 = sg(p0)
            _dir = normalize(sg(bss.p2) - _p0)
            pdf = bss.pdf
            # visibility p0 -> p2 + differentiable far triangle; the hit
            # must BE the emitter point p2, so the emitter-first query
            # replaces the full-scene closest hit exactly (see
            # DirectIntegrator.eval_secondary_edge)
            from ..scene.scene import ray_intersect_emitter_first
            if flat.em_tri_idx is not None:
                its2_full, tri_info = ray_intersect_emitter_first(
                    flat, Ray(_p0, _dir), valid, want_tri_info=True)
            else:  # > 8192 emitter faces: the dense emitter sweep loses
                its2_full, tri_info = ray_intersect(
                    flat, Ray(_p0, _dir), valid, path_space=True,
                    want_tri_info=True)
            _its2 = jax.tree.map(sg, its2_full)
            valid = (valid & _its2.valid
                     & (norm(_its2.p - sg(bss.p2)) < ShadowEpsilon))
            L = sg(scene_le(flat, _its2, valid))
            far_n = sg(bss.n)
        else:
            edge_idx, pdf0, s1 = discrete_sample_reuse(flat.sec_distrb,
                                                       sample3[..., 0])
            info: SecondaryEdgeInfo = jax.tree.map(lambda a: a[edge_idx],
                                                   flat.sec_edge)
            ok = info.valid & (flat.sec_distrb.pmf[edge_idx] > 0.0)
            p0 = info.p0 + info.e1 * s1[..., None]
            edge = normalize(sg(info.e1))
            edge2 = sg(info.p2) - sg(info.p0)
            pdf0 = pdf0 / jnp.maximum(norm(sg(info.e1)), 1e-20)
            _dir = warp_mod.square_to_uniform_sphere(sample3[..., 1:3])
            pdf = pdf0 / (4.0 * jnp.pi)
            sgn0 = sign_eps(dot(sg(info.n0), _dir), EdgeEpsilon)
            sgn1 = sign_eps(dot(sg(info.n1), _dir), EdgeEpsilon)
            boundary = sg(info.is_boundary)
            valid = ok & jnp.where(boundary, sgn0 != 0, sgn0 * sgn1 < 0)
            _p0 = sg(p0)
            its2_full, tri_info = ray_intersect(flat, Ray(_p0, _dir), valid,
                                                path_space=True,
                                                want_tri_info=True)
            _its2 = jax.tree.map(sg, its2_full)
            valid = valid & _its2.valid
            far_n = _its2.n
            helper = PathTracer(max_depth=max(1, self.max_depth - 1),
                                hide_emitters=True)
            L = sg(helper.Li(scene, flat_det, rng, Ray(_p0, _dir), valid))

        # sensor-side anchor p1
        _its1 = jax.tree.map(sg, ray_intersect(flat, Ray(_p0, -_dir), valid,
                                               path_space=True))
        valid = valid & _its1.valid & (_its1.bsdf_id >= 0)
        _p1 = _its1.p
        _p2 = _its2.p

        # edge-local geometric kernel (direct.cpp:266-274): base_v's t is
        # _its1.t = |p0 - p1|, the edge-to-receiver distance — a property
        # of the boundary segment alone, independent of the sensor subpath
        dist = norm(_p2 - _p1)
        cos2 = jnp.abs(dot(far_n, -_dir))
        e = cross(edge, _dir)
        sinphi = norm(e)
        proj = normalize(cross(e, far_n))
        sinphi2 = norm(cross(_dir, proj))
        valid = valid & (sinphi > Epsilon) & (sinphi2 > Epsilon)
        kernel = _mdiv(sinphi, sinphi2, valid) * cos2
        kernel = _mdiv(kernel, pdf, valid & (pdf > 0.0))

        # AD normal-velocity factor, anchored at the detached p1
        nrm = normalize(cross(far_n, proj))
        sign_f = jnp.sign(dot(e, edge2)) * jnp.sign(dot(e, nrm))
        v0, te1, te2 = tri_info.p0, tri_info.e1, tri_info.e2
        sh_dir = normalize(p0 - _p1)
        uv, _ = ray_intersect_triangle(v0, te1, te2, _p1, sh_dir)
        u2 = bilinear(sg(v0), sg(te1), sg(te2), uv)
        ad_term = dot(sg(nrm), u2)

        def adjoint_bsdf(its, wo_world, active):
            """f * cos(wo) with the adjoint shading-normal correction
            (direct.cpp:277-294 applied at every sensor-subpath vertex)."""
            wo_local = to_local(its.sh_frame, wo_world)
            f = eval_bsdf(kinds, bsdfs_det, its, wo_local, active)
            inc_world = to_world(its.sh_frame, its.wi)
            num = its.wi[..., 2] * dot(wo_world, its.n)
            den = wo_local[..., 2] * dot(inc_world, its.n)
            corr = jnp.abs(_mdiv(num, den, active & (den != 0.0)))
            return f * corr[..., None]

        kernel = kernel * _mdiv(_its1.t, dist, valid)

        splats = []
        if include_s1:
            # s = 1 estimator on the SHARED boundary segment (fused pass):
            # exactly eval_secondary_edge / eval_secondary_edge_indirect's
            # tail — differentiable camera recompute at p1 anchors the AD
            # term — reusing this eval's bss/far-trace/L/anchor/kernel.
            sds1 = sample_direct(sensor, _p1)
            v1 = valid & sds1.valid
            cam_ray1 = sample_primary_ray(sensor, sds1.q)
            t1 = norm(_p1 - sg(cam_ray1.o))
            occ1 = ray_test(flat, cam_ray1, t1, v1, sparse=True)
            vis1 = v1 & ~occ1
            known1 = HitRecord(
                valid=vis1, tri_id=jnp.where(vis1, _its1.tri_id, -1),
                uv=jnp.zeros(vis1.shape + (2,), jnp.float32), t=t1)
            its1d = ray_intersect(flat, cam_ray1, vis1, path_space=False,
                                  hit=known1)
            v1 = (vis1 & its1d.valid
                  & (norm(sg(its1d.p) - _p1) < ShadowEpsilon))
            f1 = adjoint_bsdf(_its1, -sg(cam_ray1.d), v1)
            value0_1 = f1 * L * (kernel * sds1.sensor_val * sign_f)[..., None]
            value0_1 = jnp.where(v1[..., None], value0_1, 0.0)
            sh_dir1 = normalize(p0 - its1d.p)
            uv1, _ = ray_intersect_triangle(v0, te1, te2, its1d.p, sh_dir1)
            u2_1 = bilinear(sg(v0), sg(te1), sg(te2), uv1)
            res1 = sg(value0_1) * dot(sg(nrm), u2_1)[..., None]
            res1 = jnp.where(v1[..., None], res1, 0.0)
            splats.append((jnp.where(v1, sds1.pixel_idx, -1),
                           res1 - sg(res1)))
        its_cur = _its1
        thr = jnp.ones((m, 3), jnp.float32)
        walk_valid = valid
        for step in range(2, self.camera_depth + 1):
            bs = sample_bsdf(kinds, bsdfs_det, its_cur, rng.next_3d(m),
                             walk_valid)
            walk_valid = walk_valid & bs.valid & (bs.pdf > 0.0)
            wo_world = to_world(its_cur.sh_frame, bs.wo)
            f_step = adjoint_bsdf(its_cur, wo_world, walk_valid)
            thr = thr * _mdiv(f_step, bs.pdf[..., None],
                              (walk_valid & (bs.pdf > 0.0))[..., None])
            its_next = jax.tree.map(sg, ray_intersect(
                flat, Ray(its_cur.p, wo_world), walk_valid,
                path_space=True))
            walk_valid = walk_valid & its_next.valid & (its_next.bsdf_id >= 0)
            its_cur = its_next

            # camera connection at q_step: the target triangle is known
            # (its_cur), so a tmax-bounded any-hit + known-triangle
            # recompute replaces the full closest hit (see
            # DirectIntegrator.eval_secondary_edge camera trace)
            sds = sample_direct(sensor, its_cur.p)
            con_valid = walk_valid & sds.valid
            camera_ray = sample_primary_ray(sensor, sds.q)
            t_cam = norm(sg(its_cur.p) - sg(camera_ray.o))
            occluded = ray_test(flat, camera_ray, t_cam, con_valid,
                                sparse=True)
            con_vis = con_valid & ~occluded
            known = HitRecord(valid=con_vis,
                              tri_id=jnp.where(con_vis, its_cur.tri_id, -1),
                              uv=jnp.zeros(con_vis.shape + (2,), jnp.float32),
                              t=t_cam)
            itsc = ray_intersect(flat, camera_ray, con_vis,
                                 path_space=False, hit=known)
            con_valid = (con_vis & itsc.valid
                         & (norm(sg(itsc.p) - its_cur.p) < ShadowEpsilon))
            f_cam = adjoint_bsdf(its_cur, -sg(camera_ray.d), con_valid)

            value0 = (thr * f_cam * L
                      * (kernel * sds.sensor_val * sign_f)[..., None])
            value0 = jnp.where(con_valid[..., None], value0, 0.0)
            result = sg(value0) * ad_term[..., None]
            result = jnp.where(con_valid[..., None], result, 0.0)
            pix = jnp.where(con_valid, sds.pixel_idx, -1)
            splats.append((pix, result - sg(result)))
        return splats

    def render_indirect_edges(self, scene: Scene, flat: FlatScene,
                              sensor_id: int, key: jax.Array,
                              shard=None) -> jax.Array:
        from ..core.math import scrub_nonfinite
        from .base import accumulate_image, scan_lane_chunks

        opts = scene.opts
        num_pixels = opts.num_pixels
        n = num_pixels * opts.sppse

        warp = self.ind_warpper.get(sensor_id)

        flat_det = detach_flat(flat)

        def eval_tail(sample3_t, pdf0_t, live_t, rng, weight_t=None):
            from ..core.constants import Epsilon
            pix, value = self.eval_secondary_edge_indirect(
                scene, flat, sensor_id, sample3_t, rng)
            value = scrub_nonfinite(value)
            value = jnp.where(
                (pdf0_t > Epsilon)[..., None],
                value / jnp.where(pdf0_t > Epsilon, pdf0_t, 1.0)[..., None],
                value)
            if weight_t is not None:
                # overflow re-weight on the value: keeps the guiding-pdf
                # Epsilon gate above at its own threshold
                value = value * weight_t[..., None]
            if opts.sppse > 1:
                value = value / opts.sppse
            return accumulate_image(
                jnp.where(live_t[..., None], value, 0.0),
                jnp.where(live_t, pix, -1), num_pixels)

        def run_lanes(lane, key_c):
            from ..core.distribution import hypercube_sample_reuse
            rng = RngStream(key_c, salt=3)
            m = lane.shape[0]
            sample3 = rng.next_3d(m)
            # group same-edge lanes (see direct.py render_secondary_edges)
            sample3 = sample3[jnp.argsort(sample3[:, 0])]
            if warp is not None:
                sample3, pdf0 = hypercube_sample_reuse(warp, sample3)
            else:
                pdf0 = jnp.ones((m,), jnp.float32)
            live = lane < n
            elig = _compact_eligibility(m, guided=warp is not None)
            if elig is None:
                return eval_tail(sample3, pdf0, live, rng)
            s, ks = elig
            # silhouette-valid lanes are ~3% (cbox): compact before
            # the expensive detached far-side walk
            v = _direction_segment_valid(flat_det, sg(sample3))
            idx, weight, live_c = _compact_boundary_lanes(
                v & live, sample3[:, 0], rng.next_1d(m), s, ks)
            return eval_tail(sample3[idx], pdf0[idx], live_c, rng,
                             weight_t=weight)

        from .base import shard_lane_range
        lane_range = shard and shard_lane_range(n, shard)
        return scan_lane_chunks(run_lanes, n, num_pixels, key,
                                opts.pass_lanes, lane_range,
                                remat=opts.resolve_remat(
                                    n if lane_range is None else lane_range[1]))

    def eval_secondary_edge_indirect(self, scene: Scene, flat: FlatScene,
                                     sensor_id: int, sample3: jax.Array,
                                     rng: RngStream, ad: bool = True):
        """Direction-sampled boundary segment with a path-traced far side.

        Structure mirrors DirectIntegrator.eval_secondary_edge
        (direct.cpp:224-316) with three changes: (1) the far endpoint is the
        first hit along a uniformly-sampled sphere direction (pdf already in
        solid angle — the reference converts its emitter-area pdf to the
        same measure); (2) its radiance is a detached (max_depth-1)-bounce
        estimate with the far surface's own emission excluded; (3) no
        emitter-orientation validity test.
        """
        from ..bsdf import eval_bsdf
        from ..core import warp as warp_mod
        from ..core.constants import Epsilon, ShadowEpsilon
        from ..core.math import (bilinear, cross, norm, normalize,
                                 ray_intersect_triangle)
        from ..core.distribution import discrete_sample_reuse
        from ..core.math import sign_eps
        from ..core.constants import EdgeEpsilon
        from ..sensor.perspective import sample_direct, sample_primary_ray
        from ..shape.mesh import SecondaryEdgeInfo

        kinds = scene.bsdf_kinds
        sensor = flat.sensors[sensor_id]
        flat_det = detach_flat(flat)

        # edge point (differentiable in p0), scene.cpp:456-468 pattern
        edge_idx, pdf0, s1 = discrete_sample_reuse(flat.sec_distrb,
                                                   sample3[..., 0])
        info: SecondaryEdgeInfo = jax.tree.map(lambda a: a[edge_idx],
                                               flat.sec_edge)
        ok = info.valid & (flat.sec_distrb.pmf[edge_idx] > 0.0)
        p0 = info.p0 + info.e1 * s1[..., None]
        edge = normalize(sg(info.e1))
        edge2 = sg(info.p2) - sg(info.p0)
        pdf0 = pdf0 / jnp.maximum(norm(sg(info.e1)), 1e-20)

        # far-side direction (solid-angle measure)
        _dir = warp_mod.square_to_uniform_sphere(sample3[..., 1:3])
        pdf = pdf0 / (4.0 * jnp.pi)

        # silhouette validity wrt the sampled direction
        sgn0 = sign_eps(dot(sg(info.n0), _dir), EdgeEpsilon)
        sgn1 = sign_eps(dot(sg(info.n1), _dir), EdgeEpsilon)
        boundary = sg(info.is_boundary)
        valid = ok & jnp.where(boundary, sgn0 != 0, sgn0 * sgn1 < 0)

        _p0 = sg(p0)
        # far side: first hit is the moving-shadow caster's background
        its2_full, tri_info = ray_intersect(flat, Ray(_p0, _dir), valid,
                                            path_space=True,
                                            want_tri_info=True)
        _its2 = jax.tree.map(sg, its2_full)
        valid = valid & _its2.valid
        _p2 = _its2.p
        far_n = _its2.n

        # detached reflected-only radiance arriving at the edge from _dir
        helper = PathTracer(max_depth=max(1, self.max_depth - 1),
                            hide_emitters=True)
        L = sg(helper.Li(scene, flat_det, rng, Ray(_p0, _dir), valid))

        # camera side (identical to the direct estimator from here on)
        _its1 = jax.tree.map(sg, ray_intersect(flat, Ray(_p0, -_dir), valid,
                                               path_space=True))
        valid = valid & _its1.valid
        _p1 = _its1.p

        sds = sample_direct(sensor, _p1)
        valid = valid & sds.valid

        # p1's triangle is known from the sensor-side anchor trace: bounded
        # any-hit + known-triangle recompute instead of a full closest hit
        camera_ray = sample_primary_ray(sensor, sds.q)
        t_cam = norm(_p1 - sg(camera_ray.o))
        occluded = ray_test(flat, camera_ray, t_cam, valid, sparse=True)
        vis = valid & ~occluded
        known = HitRecord(valid=vis,
                          tri_id=jnp.where(vis, _its1.tri_id, -1),
                          uv=jnp.zeros(vis.shape + (2,), jnp.float32),
                          t=t_cam)
        its1 = ray_intersect(flat, camera_ray, vis, path_space=False,
                             hit=known)
        valid = vis & its1.valid & (norm(sg(its1.p) - _p1) < ShadowEpsilon)

        dist = norm(_p2 - _p1)
        cos2 = jnp.abs(dot(far_n, -_dir))
        e = cross(edge, _dir)
        sinphi = norm(e)
        proj = normalize(cross(e, far_n))
        sinphi2 = norm(cross(_dir, proj))
        base_v = (_mdiv(_its1.t, dist, valid)
                  * _mdiv(sinphi, sinphi2, valid) * cos2)
        valid = valid & (sinphi > Epsilon) & (sinphi2 > Epsilon)

        bsdfs_det = jax.tree.map(sg, flat.bsdfs)
        d0 = -sg(camera_ray.d)
        d0_local = to_local(_its1.sh_frame, d0)
        bsdf_val = eval_bsdf(kinds, bsdfs_det, _its1, d0_local, valid)
        corr_num = _its1.wi[..., 2] * dot(d0, _its1.n)
        corr_den = d0_local[..., 2] * dot(_dir, _its1.n)
        correction = jnp.abs(_mdiv(corr_num, corr_den,
                                   valid & (corr_den != 0.0)))
        bsdf_val = bsdf_val * correction[..., None]

        value0 = bsdf_val * L * (base_v * sds.sensor_val)[..., None]
        value0 = _mdiv(value0, pdf, valid & (pdf > 0.0))
        value0 = jnp.where(valid[..., None], value0, 0.0)

        if not ad:  # guiding variant (direct.cpp:312-315 analog)
            return jnp.full(valid.shape, -1, jnp.int32), jnp.abs(value0)

        nrm = normalize(cross(far_n, proj))
        value0 = value0 * (jnp.sign(dot(e, edge2))
                           * jnp.sign(dot(e, nrm)))[..., None]

        v0, e1, e2 = tri_info.p0, tri_info.e1, tri_info.e2
        sh_dir = normalize(p0 - its1.p)
        uv, _ = ray_intersect_triangle(v0, e1, e2, its1.p, sh_dir)
        u2 = bilinear(sg(v0), sg(e1), sg(e2), uv)

        result = sg(value0) * dot(sg(nrm), u2)[..., None]
        result = jnp.where(valid[..., None], result, 0.0)
        pix = jnp.where(valid, sds.pixel_idx, -1)
        return pix, result - sg(result)

    def preprocess_secondary_edges(self, scene, sensor_id, reso,
                                   nrounds: int = 1, seed: int = 0,
                                   mesh=None):
        helper = DirectIntegrator(1, 1)
        helper.warpper = self.warpper
        helper.preprocess_secondary_edges(scene, sensor_id, reso, nrounds,
                                          seed, mesh=mesh)
        self.warpper = helper.warpper

    def preprocess_indirect_edges(self, scene, sensor_id, reso,
                                  nrounds: int = 1, seed: int = 0,
                                  mesh=None):
        """Guiding table for the indirect boundary term: Monte-Carlo cell
        masses of |value| over the (edge, direction) cube.

        ``mesh``: optional 1D device mesh — lanes are sharded over the axis
        and masses ``psum``'d so every process holds the same table. Unlike
        the direct table this build is *statistically* (not bit-) identical
        to the serial one: the estimator draws per-lane randomness inside
        the far-side walk, so each device folds its index into the key."""
        from ..core.distribution import hypercube_init, hypercube_set_mass
        from ..core.math import scrub_nonfinite
        assert nrounds > 0
        reso = tuple(int(r) for r in reso)
        hc = hypercube_init(reso[:3])
        num_cells = hc.num_cells
        spp_cell = reso[3]
        n = num_cells * spp_cell

        flat = detach_flat(scene.flat)
        idx = jnp.arange(n, dtype=jnp.int32) // spp_cell
        base = hc.cells[idx].astype(jnp.float32)

        def eval_lanes(base_l, idx_l, rng):
            m = base_l.shape[0]
            sample3 = (base_l + rng.next_3d(m)) * hc.unit
            _, value0 = self.eval_secondary_edge_indirect(
                scene, flat, sensor_id, sample3, rng, ad=False)
            value0 = scrub_nonfinite(value0)
            if spp_cell > 1:
                value0 = value0 / spp_cell
            return jax.ops.segment_sum(jnp.max(value0, axis=-1), idx_l,
                                       num_segments=num_cells + 1)[:num_cells]

        if mesh is None:
            @jax.jit
            def f(keys):
                # all rounds in ONE program (lax.scan), as in the direct
                # build: nrounds is 16-32 at reference scale, and one
                # program beats that many eager dispatches
                def body(acc, k):
                    return acc + eval_lanes(base, idx, RngStream(k)), None
                mass, _ = jax.lax.scan(
                    body, jnp.zeros((num_cells,), jnp.float32), keys)
                return mass
        else:
            import functools
            from jax import shard_map
            from jax.sharding import PartitionSpec as P
            axis = mesh.axis_names[0]
            n_dev = mesh.devices.size
            count = -(-n // n_dev)
            pad = n_dev * count - n
            base_p = jnp.pad(base, ((0, pad), (0, 0)))
            idx_p = jnp.pad(idx, (0, pad), constant_values=num_cells)

            def rounds_dev(base_in, idx_in, keys):
                d = jax.lax.axis_index(axis)
                start = d * count
                sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, count)

                def body(acc, key):
                    m = eval_lanes(sl(base_in), sl(idx_in),
                                   RngStream(jax.random.fold_in(key, d)))
                    return acc + jax.lax.psum(m, axis), None

                mass, _ = jax.lax.scan(
                    body, jnp.zeros((num_cells,), jnp.float32), keys)
                return mass

            f = jax.jit(shard_map(rounds_dev, mesh=mesh,
                                  in_specs=(P(), P(), P()), out_specs=P(),
                                  check_vma=False))
            f = functools.partial(f, base_p, idx_p)

        keys = jax.random.split(jax.random.PRNGKey(seed), nrounds)
        mass = f(keys)
        if nrounds > 1:
            mass = mass / nrounds
        self.ind_warpper[sensor_id] = hypercube_set_mass(hc, mass)
