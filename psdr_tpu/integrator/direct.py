"""One-bounce direct-illumination integrator with MIS + PSDR boundary terms.

Parity reference: psdr-cuda src/integrator/direct.cpp —
* __Li (direct.cpp:46-163): m BSDF samples + n light samples, power-2 MIS;
  the AD path converts BSDF-sampled hits to area measure with a detached
  geometry factor (direct.cpp:83-95) and multiplies the reparam J;
* render_secondary_edges (direct.cpp:207-221) + eval_secondary_edge
  (direct.cpp:224-316): the direct boundary integral — boundary segment
  (p0 on a silhouette edge, p2 on an emitter), occlusion checks via three
  detached traces + one differentiable camera-ray trace, geometric factor
  (t/dist)(sin phi/sin phi2)cos2, shading-normal asymmetry correction, and
  the AD normal-velocity term dot(n, u2) with result - stop_gradient(result);
* preprocess_secondary_edges (direct.cpp:166-204): Monte-Carlo cell-mass
  estimation feeding a 3D hypercube guiding distribution.

All masked divisions route through ``_mdiv`` so masked-out lanes can never
poison reverse-mode gradients with 0 * inf = NaN.
"""
from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp

from ..bsdf import (all_reflective_one_sided, eval_bsdf, pdf_bsdf,
                    sample_bsdf)
from ..core.constants import Epsilon, ShadowEpsilon
from ..core.distribution import (hypercube_init, hypercube_sample_reuse,
                                 hypercube_set_mass)
from ..core.frame import to_local, to_world
from ..core.math import (bilinear, cross, dot, mis_weight, norm, normalize,
                         ray_intersect_triangle, scrub_nonfinite, sqr,
                         squared_norm)
from ..accel.bruteforce import HitRecord
from ..core.records import Ray
from ..core.sampler import RngStream
from ..emitter.envmap import envmap_eval_direction
from ..scene.scene import (FlatScene, Scene, detach_flat, emitter_position_pdf,
                           ray_intersect, ray_intersect_emitter_first,
                           ray_intersect_with_prior, ray_test,
                           sample_boundary_segment_direct,
                           sample_emitter_position, scene_le, select_rows)
from ..sensor.perspective import sample_direct, sample_primary_ray
from .base import Integrator, accumulate_image

sg = jax.lax.stop_gradient


def _stratify2(u2, rng, which: int):
    """Improve a uniform 2D sample with the pixel's sample-index
    structure when the upstream interior render attached it:

    * ``rng.ld`` (sampler="sobol"): REPLACE u2 with the pixel's
      scrambled (0,2)-sequence point — ``which`` picks the NEE or BSDF
      scramble pair so consumers decorrelate (padded randomized QMC).
    * ``rng.strata`` (sampler="stratified"): warp u2 onto the spp strata
      with a per-pixel rotation; strata = (s_idx, spp, (a, b), rot_nee,
      rot_bsdf). Marginally still uniform ("padded" stratified).

    No-op when neither is present (boundary-estimator RNG streams)."""
    ld = getattr(rng, "ld", None)
    if ld is not None:
        from ..core.sampler import ld_2d
        s_idx, nee_x, nee_y, bsdf_x, bsdf_y = ld
        if which == 0:
            return ld_2d(s_idx, nee_x, nee_y)
        return ld_2d(s_idx, bsdf_x, bsdf_y)
    strata = getattr(rng, "strata", None)
    if strata is None:
        return u2
    s_idx, spp, (a, b), rot_nee, rot_bsdf = strata
    s = (s_idx + (rot_nee if which == 0 else rot_bsdf)) % spp
    cell = jnp.stack([(s % a).astype(jnp.float32),
                      (s // a).astype(jnp.float32)], axis=-1)
    return (cell + u2) / jnp.array([a, b], jnp.float32)


def _mdiv(a, b, mask):
    """a / b with the divisor forced to 1 on masked-out lanes."""
    if b.ndim < a.ndim:
        mask_b = mask
        b = jnp.where(mask_b, b, 1.0)
        return a / b[..., None] if a.ndim > b.ndim else a / b
    return a / jnp.where(mask, b, 1.0)


def _compact_eligibility(m: int, guided: bool = False):
    """(segment, keep) sizes for boundary-pass compaction, or None when the
    wavefront doesn't factor / is too small / compaction is disabled
    (PSDR_TPU_SSE_COMPACT=0). One predicate for all four boundary passes.

    Unguided sampling passes ~3% validity (cbox), so the
    keep fraction is s/16 — every downstream trace/walk/shade runs at
    1/16 width with huge per-segment headroom (32k * 3% ~ 1k of 2k).
    GUIDED streams concentrate on valid regions (validity can exceed
    50%), so they keep the conservative s/4. PSDR_TPU_SSE_COMPACT_SHIFT
    overrides both."""
    s = min(1 << 15, m)
    # full 32k segments (production chunks) have the statistical headroom
    # for 1/16; small test-scale wavefronts keep the conservative 1/4
    shift = int(os.environ.get(
        "PSDR_TPU_SSE_COMPACT_SHIFT",
        "4" if (not guided and s == (1 << 15)) else "2"))
    ks = s >> shift
    if (m % s or ks < 256
            or os.environ.get("PSDR_TPU_SSE_COMPACT", "1") != "1"):
        return None
    return s, ks


def _compact_boundary_lanes(valid_eff, edge_coord, u_sel, s: int, ks: int):
    """Shared boundary-pass compaction: keep the first ``ks`` lanes of each
    ``s``-lane segment after sorting valid lanes first by the uniform key
    ``u_sel`` (a uniform-random subset when a segment overflows), then
    restore edge coherence by re-sorting the kept lanes by ``edge_coord``.

    Returns ``(idx, weight, live)``: gather indices into the full wavefront
    (m//s*ks,), the per-lane unbiasedness weight max(1, count/ks) (1 when
    the segment's valid lanes all fit — then the compacted estimator is
    EXACT), and the kept-lane liveness mask. Sorts are segmented — a flat
    wavefront-sized 1D argsort (and a lax.cond fallback) hit pathological
    42-128x padded XLA layouts and ran out of memory."""
    m = valid_eff.shape[0]
    key2 = jnp.where(valid_eff, sg(u_sel), 2.0)
    local = jnp.argsort(key2.reshape(m // s, s), axis=1,
                        stable=True)[:, :ks].astype(jnp.int32)
    base = (jnp.arange(m // s, dtype=jnp.int32) * s)[:, None]
    sel = (local + base).reshape(-1)
    counts = valid_eff.reshape(m // s, s).sum(axis=1)
    weight = jnp.repeat(jnp.maximum(
        1.0, counts.astype(jnp.float32) / ks), ks)
    live_c = valid_eff[sel]
    key3 = jnp.where(live_c, sg(edge_coord[sel]), 2.0)
    local2 = jnp.argsort(key3.reshape(m // s, ks), axis=1,
                         stable=True).astype(jnp.int32)
    base2 = (jnp.arange(m // s, dtype=jnp.int32) * ks)[:, None]
    sel2 = (local2 + base2).reshape(-1)
    # weight is segment-constant, so it survives the within-segment re-sort
    return sel[sel2], weight, live_c[sel2]


def _emitter_meta(scene: Scene):
    meta = []
    for e in scene.emitters:
        if e.kind == "area":
            meta.append(("area", e.mesh_index))
        else:
            meta.append(("env", -1))
    if not meta:
        meta.append(("area", 0))
    return tuple(meta)


class DirectIntegrator(Integrator):
    def __init__(self, bsdf_samples: int = 1, light_samples: int = 1,
                 hide_emitters: bool = False):
        assert bsdf_samples >= 0 and light_samples >= 0
        assert bsdf_samples + light_samples > 0
        self.bsdf_samples = bsdf_samples
        self.light_samples = light_samples
        self.hide_emitters = hide_emitters
        self.warpper: dict[int, object] = {}  # per-sensor guiding HyperCube

    # -- interior Li (direct.cpp:46-163) --------------------------------------
    def Li(self, scene: Scene, flat: FlatScene, rng: RngStream, ray: Ray,
           active: jax.Array, prior=None) -> jax.Array:
        kinds = scene.bsdf_kinds
        emeta = _emitter_meta(scene)
        offsets = scene.face_offset
        n = ray.o.shape[0]

        # solid-angle formulation; tmax-bounded when the interior pass
        # attached a camera-hit prior (exact — see ray_intersect_with_prior)
        its = ray_intersect_with_prior(flat, ray, active, prior)
        active = active & its.valid

        result = (jnp.zeros((n, 3), jnp.float32) if self.hide_emitters
                  else scene_le(flat, its, active))
        if flat.envmap is not None:
            # skip reflectance for hits on the env bounding mesh
            active = active & (its.bsdf_id >= 0)

        for k in range(self.bsdf_samples):
            u3 = rng.next_3d(n)
            if k == 0:
                u3 = u3.at[:, 0:2].set(
                    _stratify2(u3[:, 0:2], rng, which=1))
            bs = sample_bsdf(kinds, flat.bsdfs, its, u3, active)
            active1 = active & bs.valid

            ray1 = Ray(its.p, to_world(its.sh_frame, bs.wo))
            # the bounce hit only matters where it lands on an emitter, so
            # the full-scene closest hit reduces to emitter-hit + occlusion
            if flat.em_tri_idx is not None:
                its1 = ray_intersect_emitter_first(flat, ray1, active1)
            else:
                its1 = ray_intersect(flat, ray1, active1, path_space=True,
                                     sort_rays=True)
            active1 = active1 & its1.valid & its1.is_emitter()

            # area-measure conversion with detached G (direct.cpp:83-95)
            wo = its1.p - its.p
            wo = _mdiv(wo, its1.t, active1)
            bsdf_val = eval_bsdf(kinds, flat.bsdfs, its,
                                 to_local(its.sh_frame, wo), active1)
            cos_val = dot(its1.n, -wo)
            G_val = _mdiv(jnp.abs(cos_val), sqr(its1.t), active1)
            pdf0 = bs.pdf * sg(G_val)
            bsdf_val = bsdf_val * _mdiv(G_val * its1.J, pdf0, active1)[..., None]

            weight = jnp.full((n,), 1.0 / self.bsdf_samples, jnp.float32)
            if self.light_samples > 0:
                pdf_nee = emitter_position_pdf(flat, emeta, its.p, its1, active1)
                w_num = sqr(pdf0)
                w_den = w_num + sqr(pdf_nee)
                weight = weight * _mdiv(w_num, w_den, active1 & (w_den > 0.0))
            contrib = scene_le(flat, its1, active1) * bsdf_val * weight[..., None]
            result = result + jnp.where(active1[..., None], contrib, 0.0)

        for k in range(self.light_samples):
            u2 = rng.next_2d(n)
            if k == 0:
                u2 = _stratify2(u2, rng, which=0)
            ps = sample_emitter_position(flat, offsets, emeta, its.p,
                                         u2, active)
            active1 = active & ps.valid

            wo = ps.p - its.p
            dist_sqr = squared_norm(wo)
            dist = jnp.sqrt(jnp.maximum(dist_sqr, 1e-20))
            wo = wo / dist[..., None]

            # Gate the occlusion query by the zero-contribution side tests
            # first: a lane whose light sample is behind the emitter
            # (cos <= 0) contributes nothing whether occluded or not, so it
            # need not trace; when every scene BSDF is reflective one-sided
            # (capability flag next to the dispatch tables,
            # bsdf/__init__.py), below-shading-horizon lanes are likewise
            # zero and skip too. Exact: the final contribution on gated-out
            # lanes is zero either way (pinned by renderC equality tests).
            # On cbox the entire ceiling's shadow rays drop out.
            cos_val = dot(ps.n, -wo)
            is_env = ps.emitter < 0
            side_ok = is_env | (cos_val > 0.0)
            if all_reflective_one_sided(kinds):
                side_ok = (side_ok
                           & (sg(to_local(its.sh_frame, wo))[..., 2] > 0.0)
                           & (sg(its.wi)[..., 2] > 0.0))
            active1 = active1 & side_ok

            # occlusion test with tmax pruning (reference re-traces closest
            # hit; the sampled emitter data already carries Le, n, J).
            # Envmap-sampled shadow directions are incoherent, so sort them;
            # area-light-only scenes keep the cheaper unsorted sweep (their
            # shadow rays already point at the light)
            vis = self._nee_visibility(flat, rng, its.p, wo, dist, active1,
                                       n)
            if vis is None:
                occluded = ray_test(flat, Ray(its.p, wo), dist, active1,
                                    sort_rays=flat.envmap is not None)
                active1 = active1 & ~occluded
            else:
                active1 = active1 & (vis != 0.0)

            le = jnp.where((ps.emitter >= 0)[..., None],
                           select_rows(flat.emitter_radiance,
                                       jnp.maximum(ps.emitter, 0)),
                           0.0)
            if flat.envmap is not None:
                le = jnp.where(is_env[..., None],
                               envmap_eval_direction(flat.envmap, wo,
                                                     active1 & is_env), le)

            G_val = _mdiv(jnp.abs(cos_val), dist_sqr, active1)
            wo_local = to_local(its.sh_frame, wo)
            bsdf_val = eval_bsdf(kinds, flat.bsdfs, its, wo_local, active1)
            pdf1 = pdf_bsdf(kinds, flat.bsdfs, its, wo_local, active1)
            bsdf_val = bsdf_val * _mdiv(G_val * ps.J, ps.pdf, active1)[..., None]
            pdf1 = pdf1 * sg(G_val)

            weight = jnp.full((n,), 1.0 / self.light_samples, jnp.float32)
            if self.bsdf_samples > 0:
                w_num = sqr(ps.pdf)
                w_den = w_num + sqr(pdf1)
                weight = weight * _mdiv(w_num, w_den, active1 & (w_den > 0.0))
            contrib = le * bsdf_val * weight[..., None]
            if vis is not None:
                contrib = contrib * vis[..., None]
            result = result + jnp.where(active1[..., None], contrib, 0.0)

        return result

    @staticmethod
    def _sparse_or_plain_test(flat, p, wo, dist, active, frac_shift: int):
        """ray_test with an explicit sparse compaction cap (ray_test's
        default is 1/8; the reuse second sweep needs 1/4)."""
        from ..core.constants import ShadowEpsilon
        from ..scene.scene import _ray_test_sparse
        tmax = sg(dist) - ShadowEpsilon
        if flat.accel is not None and flat.accel_kind == "pallas":
            occ = _ray_test_sparse(flat, Ray(p, wo), tmax, active,
                                   frac_shift=frac_shift)
            if occ is not None:
                return occ & active
        return ray_test(flat, Ray(p, wo), dist, active)

    def _nee_visibility(self, flat, rng, p, wo, dist, active1, n):
        return DirectIntegrator._nee_visibility_impl(
            flat, rng, p, wo, dist, active1, n,
            light_samples=self.light_samples)

    @staticmethod
    def _nee_visibility_impl(flat, rng, p, wo, dist, active1, n,
                             light_samples):
        """Unbiased NEE visibility reuse across a pixel's spp strata
        (area-light scenes, pixel-aligned chunks): all strata of a pixel
        shade nearly the same point toward the same small light, so their
        occlusion results are highly correlated. Control-variate
        estimator: stratum 0 always traces (V_ref); another stratum i
        traces with probability q and uses
            V_hat_i = V_ref + (V_i - V_ref) * B_i / q
        — exactly unbiased (E[V_hat_i] = V_i per lane, for ANY reference
        value including an untraced/inactive stratum 0 where V_ref = 0).

        Modes (PSDR_TPU_VIS_REUSE; default "edge" when the structure
        allows, "off" disables; PSDR_TPU_VIS_REUSE_Q sets q):
        * "edge" (default): a strata-{0, spp/2} pre-sweep classifies
          pixels (probe disagreement = penumbra; +-1/+-2 chunk-order
          neighbor comparison catches umbra/lit boundaries); the
          remaining strata are systematically subsampled at k_pen=4
          inside penumbra / k_smooth=32 elsewhere with k-weighted
          corrections. Classification depends only on probe results, so
          unbiasedness is untouched (the subsample selection is
          independent of the corrected lanes). Measured round 5:
          variance ratio 1.10 on cbox (1.01 bunny_env_2), flagship
          forward 46.7 -> 63.7 Mrays/s.
        * "bern" (the q-only estimator, q=1/16): fewer sweeps but the
          1/q penumbra amplification costs 1.5x image variance on cbox —
          an equal-quality wash despite +59% raw speed; kept for A/Bs.
        Traced subsets run the compacted sparse sweeps; returns per-lane
        float visibility, or None -> caller's plain path.
        """
        mode = os.environ.get("PSDR_TPU_VIS_REUSE", "edge")
        q = float(os.environ.get("PSDR_TPU_VIS_REUSE_Q", "0"))
        if q > 0.0 and "PSDR_TPU_VIS_REUSE" not in os.environ:
            mode = "bern"     # back-compat: Q alone selects the q-only mode
        spp = getattr(rng, "vis_spp", None)
        if (mode not in ("bern", "edge") or not spp or spp <= 1 or n % spp
                or light_samples != 1):
            return None
        if flat.envmap is not None and mode != "edge":
            # bern mode needs V_i ~ V_ref correlation, which envmap NEE
            # (per-stratum directions spread over the sphere) lacks
            return None
        if mode == "bern" and q <= 0.0:
            return None
        npix = n // spp
        s_idx = jnp.arange(n, dtype=jnp.int32) % spp
        first = s_idx == 0
        if mode == "bern":
            bern = rng.next_1d(n) < q
            do_trace = active1 & (first | bern)
            occ = ray_test(flat, Ray(p, wo), dist, do_trace, sparse=True)
            V = jnp.where(do_trace, 1.0 - occ.astype(jnp.float32), 0.0)
            V_ref = jnp.repeat(V.reshape(npix, spp)[:, 0], spp)
            corr = jnp.where(bern, (V - V_ref) * (1.0 / q), 0.0)
            return jnp.where(first, V, V_ref + corr)

        # --- edge mode -------------------------------------------------
        # Pre-sweep traces strata {0, spp/2}: a penumbra pixel's two
        # independent light samples disagree with probability
        # 2v(1-v) >= the per-probe detection rate of any neighbor test,
        # catching penumbra at the pixel itself; chunk-order +-1/+-2
        # neighbors (pixel-major lanes ride the 32x32 tile traversal, so
        # chunk order is x-within-tile-row) catch umbra/lit boundaries.
        # Pixels whose probes were inactive classify as edge. The second
        # sweep then SYSTEMATICALLY subsamples each pixel's remaining
        # strata — every k-th stratum from a per-pixel random offset
        # (marginal probability 1/k, so the k-weighted control-variate
        # correction stays exactly unbiased; the within-pixel negative
        # correlation beats iid Bernoulli) — at k_pen (default 4) inside
        # penumbra and k_smooth = round(1/q) (default 32) elsewhere.
        k_smooth = max(2, int(round(1.0 / q)) if q > 0.0 else 32)
        k_pen = max(1, int(os.environ.get("PSDR_TPU_VIS_REUSE_KPEN", "4")))
        h = spp // 2
        probe = first | (s_idx == h)
        act0 = active1 & probe
        occ0 = ray_test(flat, Ray(p, wo), dist, act0, sparse=True)
        V0 = jnp.where(act0, 1.0 - occ0.astype(jnp.float32), 0.0)
        Vrows = V0.reshape(npix, spp)
        Arows = act0.reshape(npix, spp)
        W = Vrows[:, 0] + Vrows[:, h]                   # 0 / 1 / 2
        Aok = Arows[:, 0] & Arows[:, h]
        smooth = Aok & (W != 1.0)
        for off in (1, 2, -1, -2):
            smooth = smooth & (jnp.roll(W, off) == W) & jnp.roll(Aok, off)
        pen_lane = jnp.repeat(~smooth, spp)
        # reference = mean of the two probes (halves the control-variate
        # distance on any residual misclassified penumbra lane)
        V_ref = jnp.repeat(0.5 * W, spp)
        u_pix = rng.next_1d(n).reshape(npix, spp)[:, 0]
        k_lane = jnp.repeat(jnp.where(~smooth, k_pen, k_smooth), spp)
        r_lane = jnp.repeat((u_pix * k_pen * k_smooth).astype(jnp.int32),
                            spp)
        B = (s_idx % k_lane) == (r_lane % k_lane)
        trace2 = active1 & ~probe & B
        # penumbra lanes cluster spatially (same sort segments), so the
        # second sweep uses the 1/4-cap compaction instead of 1/8 —
        # overflowing the cap falls back to the full sorted sweep and
        # would forfeit the whole win exactly on shadow-heavy chunks
        occ2 = DirectIntegrator._sparse_or_plain_test(
            flat, p, wo, dist, trace2, frac_shift=2)
        V2 = jnp.where(trace2, 1.0 - occ2.astype(jnp.float32), 0.0)
        corr = jnp.where(B, (V2 - V_ref) * k_lane.astype(jnp.float32), 0.0)
        return jnp.where(probe, V0, V_ref + corr)

    # -- secondary boundary (direct.cpp:207-316) -------------------------------
    def render_secondary_edges(self, scene: Scene, flat: FlatScene,
                               sensor_id: int, key: jax.Array,
                               shard=None) -> jax.Array:
        opts = scene.opts
        num_pixels = opts.num_pixels
        n = num_pixels * opts.sppse
        warp = self.warpper.get(sensor_id)

        flat_det = detach_flat(flat)
        emeta = _emitter_meta(scene)

        def eval_tail(sample3_t, pdf0_t, live_t, weight_t=None):
            pix, value = self.eval_secondary_edge(scene, flat, sensor_id,
                                                  sample3_t, ad=True)
            value = scrub_nonfinite(value)
            value = jnp.where(
                (pdf0_t > Epsilon)[..., None],
                value / jnp.where(pdf0_t > Epsilon, pdf0_t, 1.0)[..., None],
                value)
            if weight_t is not None:
                # overflow re-weight count/ks, applied to the value so the
                # guiding-pdf Epsilon gate above keeps its own threshold
                value = value * weight_t[..., None]
            if opts.sppse > 1:
                value = value / opts.sppse
            return accumulate_image(
                jnp.where(live_t[..., None], value, 0.0),
                jnp.where(live_t, pix, -1), num_pixels)

        def run_lanes(lane, key_c):
            rng = RngStream(key_c, salt=2)
            m = lane.shape[0]
            sample3 = rng.next_3d(m)
            # iid lanes: sorting by the edge-selecting coordinate is
            # measure-preserving and groups same-edge lanes into coherent
            # ray blocks (each lane carries its own pixel index)
            sample3 = sample3[jnp.argsort(sample3[:, 0])]
            if warp is not None:
                sample3, pdf0 = hypercube_sample_reuse(warp, sample3)
            else:
                pdf0 = jnp.ones((m,), jnp.float32)
            live = lane < n

            # Boundary segments are sparse: only ~3% of unguided samples
            # pass the silhouette/emitter validity (measured on cbox), yet the estimator's traces would run full-width. A
            # cheap detached sampling pre-pass finds the valid lanes and
            # the whole estimator tail (emitter-first trace, opposite
            # closest hit, camera any-hit, BSDF eval, AD term) runs on a
            # quarter-width compacted wavefront. When a 32k sort segment
            # holds more than s/4 valid lanes (possible under heavy
            # guiding concentration), a uniform-random s/4-subset is kept
            # and re-weighted by count/ks — still an unbiased estimator,
            # just higher variance in exactly those segments; below the
            # bound (the typical case, and all tests) every valid lane is
            # kept once with weight 1 and the pass is EXACT. An exact
            # lax.cond fallback was measured instead and rejected: the
            # cond's operand copies take pathological (1,N,1)/(N,3)
            # 42-128x padded layouts and ran out of device memory.
            # Sorts are segmented (32k) like every other lane sort — a
            # flat 2M-lane argsort hits the same padding.
            elig = _compact_eligibility(m, guided=warp is not None)
            if elig is None:
                return eval_tail(sample3, pdf0, live)
            s, ks = elig
            bss_v = sample_boundary_segment_direct(
                flat_det, scene.face_offset, emeta, sg(sample3), live).valid
            idx, weight, live_c = _compact_boundary_lanes(
                bss_v & live, sample3[:, 0], rng.next_1d(m), s, ks)
            return eval_tail(sample3[idx], pdf0[idx], live_c,
                             weight_t=weight)

        from .base import scan_lane_chunks, shard_lane_range
        lane_range = shard and shard_lane_range(n, shard)
        return scan_lane_chunks(run_lanes, n, num_pixels, key,
                                opts.pass_lanes, lane_range,
                                remat=opts.resolve_remat(
                                    n if lane_range is None else lane_range[1]))

    def eval_secondary_edge(self, scene: Scene, flat: FlatScene,
                            sensor_id: int, sample3: jax.Array, ad: bool):
        """Returns (pixel_idx, value). ``ad=False`` is the guiding variant
        returning |value| without the normal-velocity factor
        (direct.cpp:312-315)."""
        kinds = scene.bsdf_kinds
        emeta = _emitter_meta(scene)
        offsets = scene.face_offset
        sensor = flat.sensors[sensor_id]

        bss = sample_boundary_segment_direct(flat, offsets, emeta, sample3,
                                             jnp.ones(sample3.shape[:-1], bool))
        valid = bss.valid

        _p0 = sg(bss.p0)
        _p2 = bss.p2  # already detached
        _dir = normalize(_p2 - _p0)

        # visibility p0 -> p2; grab the differentiable TriangleInfo of the
        # hit. The segment is valid only when the closest hit IS the emitter
        # point p2, so the emitter-first query (tiny emitter closest hit +
        # sparse occlusion sweep) replaces the full-scene closest hit
        # exactly, as in the MIS bounce (ray_intersect_emitter_first doc)
        if flat.em_tri_idx is not None:
            its2_full, tri_info = ray_intersect_emitter_first(
                flat, Ray(_p0, _dir), valid, want_tri_info=True)
        else:  # > 8192 emitter faces: the dense emitter sweep loses
            its2_full, tri_info = ray_intersect(
                flat, Ray(_p0, _dir), valid, path_space=True,
                want_tri_info=True)
        _its2 = jax.tree.map(sg, its2_full)
        valid = valid & _its2.valid & (norm(_its2.p - _p2) < ShadowEpsilon)

        # opposite trace completes the boundary segment (p1, p2); lanes are
        # already edge-sorted, and an extra direction sort LOSES on-chip
        # (renderD 6.41 vs 6.80 M grad-samples/s) — the permute machinery
        # costs more than the coherence buys here
        _its1 = jax.tree.map(sg, ray_intersect(flat, Ray(_p0, -_dir), valid,
                                               path_space=True))
        valid = valid & _its1.valid
        _p1 = _its1.p

        # project p1 to the image plane
        sds = sample_direct(sensor, _p1)
        valid = valid & sds.valid

        # differentiable camera ray toward p1 (sds.q itself is detached;
        # gradients enter through the sensor matrices, perspective.cpp:130-136).
        # The camera trace only needs "is p1 visible" + a differentiable
        # recompute at p1 — and p1's triangle is already known from the
        # opposite trace — so a tmax-bounded any-hit plus a known-triangle
        # recompute replaces the reference's full closest hit
        # (direct.cpp:257-264); the epsilon check below keeps the same
        # accept set
        cam_sensor = sensor if ad else jax.tree.map(
            lambda x: sg(x) if isinstance(x, jax.Array) else x, sensor)
        camera_ray = sample_primary_ray(cam_sensor, sds.q)
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

        # geometric base value (direct.cpp:266-274)
        dist = norm(_p2 - _p1)
        cos2 = jnp.abs(dot(bss.n, -_dir))
        e = cross(bss.edge, _dir)
        sinphi = norm(e)
        proj = normalize(cross(e, bss.n))
        sinphi2 = norm(cross(_dir, proj))
        base_v = _mdiv(_its1.t, dist, valid) * _mdiv(sinphi, sinphi2, valid) * cos2
        valid = valid & (sinphi > Epsilon) & (sinphi2 > Epsilon)

        # detached BSDF at p1 (direct.cpp:277-294)
        bsdfs_det = jax.tree.map(sg, flat.bsdfs)
        d0 = -sg(camera_ray.d)
        d0_local = to_local(_its1.sh_frame, d0)
        bsdf_val = eval_bsdf(kinds, bsdfs_det, _its1, d0_local, valid)
        corr_num = _its1.wi[..., 2] * dot(d0, _its1.n)
        corr_den = d0_local[..., 2] * dot(_dir, _its1.n)
        correction = jnp.abs(_mdiv(corr_num, corr_den, valid & (corr_den != 0.0)))
        bsdf_val = bsdf_val * correction[..., None]

        le = sg(scene_le(flat, _its2, valid))
        value0 = bsdf_val * le * (base_v * sds.sensor_val)[..., None]
        value0 = _mdiv(value0, bss.pdf, valid & (bss.pdf > 0.0))
        value0 = jnp.where(valid[..., None], value0, 0.0)

        if not ad:
            return jnp.full(valid.shape, -1, jnp.int32), value0

        # AD normal-velocity term (direct.cpp:297-311)
        nrm = normalize(cross(bss.n, proj))
        value0 = value0 * (jnp.sign(dot(e, bss.edge2))
                           * jnp.sign(dot(e, nrm)))[..., None]

        v0, e1, e2 = tri_info.p0, tri_info.e1, tri_info.e2
        sh_dir = normalize(bss.p0 - its1.p)
        uv, _ = ray_intersect_triangle(v0, e1, e2, its1.p, sh_dir)
        u2 = bilinear(sg(v0), sg(e1), sg(e2), uv)

        result = sg(value0) * dot(sg(nrm), u2)[..., None]
        result = jnp.where(valid[..., None], result, 0.0)
        pix = jnp.where(valid, sds.pixel_idx, -1)
        return pix, result - sg(result)

    # -- guiding (direct.cpp:166-204) -------------------------------------------
    def preprocess_secondary_edges(self, scene: Scene, sensor_id: int,
                                   reso, nrounds: int = 1, seed: int = 0,
                                   mesh=None) -> None:
        """Build the secondary-edge guiding hypercube.

        ``mesh``: optional 1D ``jax.sharding.Mesh`` — the cell×spp lane
        domain is then sharded over the mesh axis and the per-cell masses
        ``psum``'d, so every process/device ends up with the identical
        collectively-built table (SURVEY §5.8). Each lane draws the same
        uniforms as the serial build, so the sharded mass equals the serial
        mass exactly (tests/test_parallel.py pins this)."""
        assert nrounds > 0
        reso = tuple(int(r) for r in reso)
        hc = hypercube_init(reso[:3])
        num_cells = hc.num_cells
        spp_cell = reso[3]
        n = num_cells * spp_cell

        flat = detach_flat(scene.flat)
        idx = jnp.arange(n, dtype=jnp.int32) // spp_cell
        base = hc.cells[idx].astype(jnp.float32)

        def eval_lanes(base_l, idx_l, u3):
            sample3 = (base_l + u3) * hc.unit
            _, value0 = self.eval_secondary_edge(scene, flat, sensor_id,
                                                 sample3, ad=False)
            value0 = scrub_nonfinite(value0)
            if spp_cell > 1:
                value0 = value0 / spp_cell
            # idx may carry a ``num_cells`` overflow bucket for padded lanes
            return jax.ops.segment_sum(jnp.max(value0, axis=-1), idx_l,
                                       num_segments=num_cells + 1)[:num_cells]

        if mesh is None:
            def one_round(key):
                rng = RngStream(key)
                return eval_lanes(base, idx, rng.next_3d(n))

            @jax.jit
            def f(keys):
                # all rounds in ONE program (lax.scan): nrounds is 16-32
                # at the reference's guiding scale, and one program beats
                # that many eager dispatches
                def body(acc, k):
                    return acc + one_round(k), None
                mass, _ = jax.lax.scan(
                    body, jnp.zeros((num_cells,), jnp.float32), keys)
                return mass
        else:
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

                def body(acc, key):
                    # full-domain draw then slice: lane l sees the same
                    # uniform on every device AND in the serial build,
                    # making the psum of disjoint slices bit-identical to
                    # the serial mass
                    rng = RngStream(key)
                    u3 = rng.next_3d(n_dev * count)
                    sl = lambda a: jax.lax.dynamic_slice_in_dim(
                        a, start, count)
                    m = eval_lanes(sl(base_in), sl(idx_in), sl(u3))
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
        self.warpper[sensor_id] = hypercube_set_mass(hc, mass)
