"""Perspective pinhole camera, incl. the primary-edge (silhouette) pipeline.

Parity reference: psdr-cuda src/sensor/perspective.cpp —
* configure builds camera_to_sample / world_to_sample and the importance
  normalization inv_area (perspective.cpp:11-33);
* primary-edge list: project silhouette-candidate edges to the sample plane,
  front/back-face filtered (perspective.cpp:39-111) — compaction replaced by
  a validity mask feeding zero weight into the edge distribution;
* sample_primary_ray (perspective.cpp:120-136), sample_direct
  (perspective.cpp:139-155), sample_primary_edge (perspective.cpp:158-200).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.constants import Epsilon, EdgeEpsilon, ShadowEpsilon
from ..core import transform as xform
from ..core.distribution import Discrete, discrete_init, discrete_sample_reuse
from ..core.math import dot, norm, normalize, sqr
from ..core.records import Ray, SensorDirectSample, PrimaryEdgeSample
from ..shape.mesh import TriangleInfo

sg = jax.lax.stop_gradient


class PerspectiveCamera:
    kind = "perspective"

    def __init__(self, fov_x: float, near: float = 1e-2, far: float = 1e4,
                 to_world=None):
        self.fov_x = float(fov_x)
        self.near_clip = float(near)
        self.far_clip = float(far)
        self.to_world = (np.eye(4, dtype=np.float32) if to_world is None
                         else np.asarray(to_world, np.float32))

    def params(self) -> dict:
        return {"to_world": self.to_world}

    def set_params(self, p: dict) -> None:
        self.to_world = p["to_world"]

    def set_transform(self, mat) -> None:
        self.to_world = np.asarray(mat, np.float32)

    def __repr__(self):
        return f"PerspectiveCamera[fov={self.fov_x}]"


class PrimaryEdgeInfo(NamedTuple):
    """Screen-space silhouette candidates (edge/edge.h:27-42). Endpoints
    keep their sample-space depth (z) so the visibility-check ray can
    recover the world-space edge point (edge.h:19-31 vis-check layout)."""
    valid: jax.Array        # (E,) bool
    p0: jax.Array           # (E, 3) sample-plane coords + depth, differentiable
    p1: jax.Array           # (E, 3)
    edge_normal: jax.Array  # (E, 2) detached
    edge_length: jax.Array  # (E,) detached screen-space length
    distrb: Discrete


class SensorState(NamedTuple):
    """Differentiable runtime state of a perspective sensor."""
    resolution: tuple       # static (W, H)
    to_world: jax.Array
    camera_to_sample: jax.Array
    sample_to_camera: jax.Array
    world_to_sample: jax.Array
    sample_to_world: jax.Array
    camera_pos: jax.Array   # (3,)
    camera_dir: jax.Array   # (3,)
    inv_area: jax.Array     # scalar importance normalization
    edges: PrimaryEdgeInfo | None


def configure_sensor(cam: PerspectiveCamera, to_world: jax.Array,
                     resolution) -> SensorState:
    width, height = int(resolution[0]), int(resolution[1])
    aspect = width / height
    camera_to_sample = xform.matmul(
        xform.matmul(xform.scale(jnp.array([-0.5, -0.5 * aspect, 1.0])),
                     xform.translate(jnp.array([-1.0, -1.0 / aspect, 0.0]))),
        xform.perspective(cam.fov_x, cam.near_clip, cam.far_clip))
    sample_to_camera = jnp.linalg.inv(camera_to_sample)
    world_to_sample = xform.matmul(camera_to_sample, jnp.linalg.inv(to_world))
    sample_to_world = xform.matmul(to_world, sample_to_camera)

    zero3 = jnp.zeros((3,), jnp.float32)
    camera_pos = xform.transform_pos(to_world, zero3)
    camera_dir = xform.transform_dir(to_world, jnp.array([0.0, 0.0, 1.0]))

    v00 = xform.transform_pos(sample_to_camera, jnp.array([0.0, 0.0, 0.0]))
    v10 = xform.transform_pos(sample_to_camera, jnp.array([1.0, 0.0, 0.0]))
    v11 = xform.transform_pos(sample_to_camera, jnp.array([1.0, 1.0, 0.0]))
    vc = xform.transform_pos(sample_to_camera, jnp.array([0.5, 0.5, 0.0]))
    inv_area = (1.0 / (norm(v00 - v10) * norm(v11 - v10))) * jnp.sum(vc * vc)

    return SensorState(resolution=(width, height), to_world=to_world,
                       camera_to_sample=camera_to_sample,
                       sample_to_camera=sample_to_camera,
                       world_to_sample=world_to_sample,
                       sample_to_world=sample_to_world,
                       camera_pos=camera_pos, camera_dir=camera_dir,
                       inv_area=inv_area, edges=None)


def build_primary_edges(state: SensorState,
                        vertex_positions: jax.Array,
                        tri_info: TriangleInfo,
                        edge_indices: np.ndarray,
                        use_face_normals: bool) -> PrimaryEdgeInfo:
    """Silhouette filter + screen projection for one mesh's edge table
    (perspective.cpp:44-104). Returns masked (not compacted) rows.
    """
    ei = jnp.asarray(edge_indices, jnp.int32)
    has_two = ei[:, 3] >= 0
    f1 = jnp.maximum(ei[:, 3], 0)

    cam = sg(state.camera_pos)
    e0 = normalize(cam - sg(tri_info.p0[ei[:, 2]]))
    e1 = normalize(cam - sg(tri_info.p0[f1]))
    n0 = sg(tri_info.face_normal[ei[:, 2]])
    n1 = sg(tri_info.face_normal[f1])

    if use_face_normals:
        skip = has_two & (((dot(e0, n0) < Epsilon) & (dot(e1, n1) < Epsilon))
                          | (dot(n0, n1) > 1.0 - Epsilon))
        keep = ~skip
    else:
        keep = (~has_two) | ((dot(e0, n0) > Epsilon) ^ (dot(e1, n1) > Epsilon))

    p0w = vertex_positions[ei[:, 0]]
    p1w = vertex_positions[ei[:, 1]]
    q0 = xform.transform_pos(state.world_to_sample, p0w)
    q1 = xform.transform_pos(state.world_to_sample, p1w)

    e = sg(q1)[..., :2] - sg(q0)[..., :2]
    length = norm(e)
    en = e / jnp.maximum(length, 1e-20)[..., None]
    edge_normal = jnp.stack([-en[..., 1], en[..., 0]], axis=-1)
    # dummy distribution; the scene stacks per-mesh tables then initializes it
    return PrimaryEdgeInfo(valid=keep, p0=q0, p1=q1, edge_normal=edge_normal,
                           edge_length=length,
                           distrb=discrete_init(jnp.ones(1)))


def finalize_primary_edges(edges: PrimaryEdgeInfo) -> PrimaryEdgeInfo:
    mass = jnp.where(edges.valid, edges.edge_length, 0.0)
    return edges._replace(distrb=discrete_init(mass))


def sample_primary_ray(state: SensorState, samples: jax.Array) -> Ray:
    """Sample-plane coords (N, 2) in [0,1)^2 -> camera rays
    (perspective.cpp:120-136)."""
    p = jnp.concatenate([samples, jnp.zeros(samples.shape[:-1] + (1,),
                                            samples.dtype)], axis=-1)
    d = normalize(xform.transform_pos(state.sample_to_camera, p))
    o = jnp.broadcast_to(xform.transform_pos(state.to_world,
                                             jnp.zeros(3, jnp.float32)),
                         d.shape)
    return Ray(o=o, d=xform.transform_dir(state.to_world, d))


def sample_direct(state: SensorState, p: jax.Array) -> SensorDirectSample:
    """Project world point to a pixel + sensor importance
    (perspective.cpp:139-155). Fully detached like the reference's C-only
    implementation."""
    width, height = state.resolution
    q = xform.transform_pos(sg(state.world_to_sample), p)[..., :2]
    iq = jnp.floor(q * jnp.array([width, height], q.dtype)).astype(jnp.int32)
    valid = ((iq[..., 0] >= 0) & (iq[..., 0] < width)
             & (iq[..., 1] >= 0) & (iq[..., 1] < height))
    pixel_idx = jnp.where(valid, iq[..., 1] * width + iq[..., 0], -1)

    d = p - sg(state.camera_pos)
    dist2 = jnp.sum(d * d, axis=-1)
    d = d / jnp.sqrt(jnp.maximum(dist2, 1e-20))[..., None]
    cos_theta = dot(sg(state.camera_dir), d)
    sensor_val = (1.0 / dist2) * (1.0 / cos_theta) ** 3 * sg(state.inv_area)
    return SensorDirectSample(valid=valid, q=q, pixel_idx=pixel_idx,
                              sensor_val=sensor_val)


def sample_primary_edge(state: SensorState, sample1: jax.Array) -> PrimaryEdgeSample:
    """Pick a point on a screen-space silhouette edge and build the +-eps
    ray pair (perspective.cpp:158-200)."""
    edges = state.edges
    width, height = state.resolution
    idx, pdf, s = discrete_sample_reuse(edges.distrb, sample1)
    # one packed row gather instead of 6 separate edge-table gathers
    packed = jnp.concatenate(
        [edges.p0, edges.p1, edges.edge_normal,
         edges.edge_length[:, None],
         edges.valid.astype(jnp.float32)[:, None],
         edges.distrb.pmf[:, None]], axis=1)[idx]
    pdf = pdf / jnp.maximum(packed[..., 8], 1e-20)
    ok = (packed[..., 9] > 0.5) & (packed[..., 10] > 0.0)

    en = packed[..., 6:8]
    p3 = (packed[..., 0:3] * (1.0 - s)[..., None]
          + packed[..., 3:6] * s[..., None])
    p_ = p3[..., :2]
    p = sg(p_)
    x_dot_n = dot(p_, en)

    ip = jnp.floor(p * jnp.array([width, height], p.dtype)).astype(jnp.int32)
    onscreen = ((ip[..., 0] >= 0) & (ip[..., 0] < width)
                & (ip[..., 1] >= 0) & (ip[..., 1] < height))
    pix = jnp.where(ok & onscreen, ip[..., 1] * width + ip[..., 0], -1)

    det_state = sg(state)
    ray_p = sample_primary_ray(det_state, p + EdgeEpsilon * en)
    ray_n = sample_primary_ray(det_state, p - EdgeEpsilon * en)
    # visibility-check ray toward the edge point itself, bounded just short
    # of it (perspective.cpp:192-197: conservative 100x ShadowEpsilon)
    ray_c = sample_primary_ray(det_state, p)
    q_world = xform.transform_pos(sg(state.sample_to_world), sg(p3))
    vis_dist = norm(q_world - sg(state.camera_pos)) - 99.0 * ShadowEpsilon
    return PrimaryEdgeSample(idx=pix, x_dot_n=x_dot_n, ray_p=ray_p,
                             ray_n=ray_n, pdf=pdf, ray_c=ray_c,
                             vis_dist=vis_dist)
