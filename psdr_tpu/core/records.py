"""Pytree record types flowing between sampling / shading stages.

Parity reference: psdr-cuda include/psdr/core/{ray.h,intersection.h,records.h},
include/psdr/bsdf/bsdf.h:10-20, include/psdr/sensor/sensor.h:11-23,
include/psdr/edge/edge.h. The C/D (detached vs autodiff) type split collapses
here: everything is a plain jnp pytree and jax.grad decides differentiation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .frame import Frame


class Ray(NamedTuple):
    o: jax.Array      # (..., 3)
    d: jax.Array      # (..., 3)

    def at(self, t: jax.Array) -> jax.Array:
        return self.o + self.d * t[..., None]

    def reversed(self) -> "Ray":
        return Ray(self.o, -self.d)


class Intersection(NamedTuple):
    """Surface interaction (intersection.h:8-52).

    ``J`` is the material-form reparameterization Jacobian: 1 in the
    solid-angle formulation; face_area / stop_grad(face_area) in path space.
    Integer ids replace the reference's per-lane object pointers.
    """
    valid: jax.Array      # (N,) bool
    t: jax.Array          # (N,)
    p: jax.Array          # (N, 3)
    n: jax.Array          # (N, 3) geometric normal
    sh_frame: Frame       # shading frame
    uv: jax.Array         # (N, 2)
    wi: jax.Array         # (N, 3) incident dir in local (shading) coords
    J: jax.Array          # (N,)
    mesh_id: jax.Array    # (N,) int32
    tri_id: jax.Array     # (N,) int32, global triangle index
    bsdf_id: jax.Array    # (N,) int32, -1 for none
    emitter_id: jax.Array  # (N,) int32, -1 for none

    def is_emitter(self) -> jax.Array:
        return self.emitter_id >= 0


class PositionSample(NamedTuple):
    """records.h:24-31 (+ the sampled emitter's index, -1 for envmap, so
    NEE can shade from the sample without re-reading the closest hit)."""
    valid: jax.Array   # bool
    pdf: jax.Array
    p: jax.Array       # (..., 3)
    n: jax.Array       # (..., 3)
    J: jax.Array
    emitter: jax.Array = -1  # int32


class BSDFSample(NamedTuple):
    """bsdf/bsdf.h:10-20; wo is in local shading coordinates."""
    valid: jax.Array
    pdf: jax.Array
    wo: jax.Array      # (..., 3)


class SensorDirectSample(NamedTuple):
    """sensor/sensor.h:11-23: projection of a world point to the sensor."""
    valid: jax.Array
    q: jax.Array          # (..., 2) sample-plane coords in [0,1)^2
    pixel_idx: jax.Array  # (...) int32, -1 if offscreen
    sensor_val: jax.Array  # importance W


class PrimaryEdgeSample(NamedTuple):
    """edge/edge.h:14-24: a point on a screen-space silhouette edge."""
    idx: jax.Array       # pixel index, -1 invalid
    x_dot_n: jax.Array   # AD-carrying normal velocity of the edge point
    ray_p: Ray           # offset ray on the positive side
    ray_n: Ray           # offset ray on the negative side
    pdf: jax.Array
    ray_c: Ray           # center ray toward the edge point (vis check)
    vis_dist: jax.Array  # camera->edge-point distance, margin applied


class BoundarySegSample(NamedTuple):
    """records.h:35-44 BoundarySegSampleDirect: p0 on an edge (differentiable),
    p2 on an emitter, pdf in area measure x direction factor."""
    valid: jax.Array
    p0: jax.Array     # (..., 3) differentiable edge point
    edge: jax.Array   # (..., 3) normalized (detached) edge direction
    edge2: jax.Array  # (..., 3) detached p2(edge endpoint-ish) - p0 of edge triangle
    p2: jax.Array     # (..., 3) emitter point (detached)
    n: jax.Array      # (..., 3) emitter normal
    pdf: jax.Array


@dataclass(frozen=True)
class RenderOptions:
    """types.h:171-182 RenderOption. Static (hashable) jit-time config."""
    width: int = 64
    height: int = 64
    spp: int = 1
    sppe: int = 0
    sppse: int = 0
    log_level: int = 0
    # reject primary-edge samples whose edge point is occluded from the
    # camera (reference compile-time PSDR_PRIMARY_EDGE_VIS_CHECK,
    # src/sensor/perspective.cpp:171-192, off by default there too)
    primary_edge_vis_check: bool = False
    # max lanes materialized at once; larger wavefronts run as an in-jit
    # lax.scan over passes (the reference's npass, fused into one program).
    # Bounds XLA HLO-temp memory. Not yet re-chosen for the GPU.
    pass_lanes: int = 1 << 21
    # checkpoint each pass chunk: the backward recomputes the chunk forward
    # instead of spilling its residual intermediates to device memory.
    # "auto" remats only wavefronts too big for residuals to fit
    # (> remat_lanes); the threshold is not yet re-chosen for the GPU.
    # True/False force it.
    remat_passes: bool | str = "auto"
    # lane count above which "auto" starts checkpointing pass chunks
    remat_lanes: int = 1 << 23

    def resolve_remat(self, count: int) -> bool:
        if self.remat_passes == "auto":
            return count > self.remat_lanes
        return bool(self.remat_passes)
    # stratify the subpixel jitter over an a x b grid when spp factorizes
    # (beyond-reference; the reference samples subpixels independently);
    # also stratifies the first NEE and first BSDF sample per pixel with
    # independent per-pixel rotations of the stratum index (direct
    # lighting and PathTracer depth 0)
    stratify_primary: bool = True
    # "sobol" (default: XOR-scrambled (0,2)-sequence over subpixel +
    # first NEE/BSDF dims — every dyadic a*b=spp grid simultaneously,
    # 5.5x lower variance than "stratified" on cbox at spp=16;
    # core/sampler.py ld_2d) | "stratified" (a x b grid, above; honors
    # stratify_primary=False -> independent) | "independent" (plain RNG,
    # the reference's behavior)
    sampler: str = "sobol"
    # camera-hit prior: a detached spp=1 pixel-center pre-trace records each
    # pixel's hit triangle; every subpixel camera ray then MTs its pixel's
    # candidate and, when it hits at t0, runs the closest-hit query with
    # tmax = t0(1+eps) — the intersection cull skips every triangle block
    # beyond the hit. Exact: a candidate hit is a real scene hit, so
    # t_closest <= t0 and the bounded query returns the same closest hit
    # (an ulp-rescue falls back to the candidate itself). Default OFF: it
    # lost its A/B on the accelerator this was first tuned on, and is not
    # yet measured on the GPU. It can pay on very-high-depth-complexity
    # scenes where the first hit hides most of the triangles. "auto" = on
    # when spp >= 4.
    camera_hit_prior: bool | str = False

    def resolve_camera_prior(self, spp: int) -> bool:
        if self.camera_hit_prior == "auto":
            return spp >= 4
        return bool(self.camera_hit_prior)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height
