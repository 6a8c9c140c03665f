"""Scene container: host-side object graph + the pure, differentiable
``build`` that produces the flattened device scene every render consumes.

Parity reference: psdr-cuda src/scene/scene.cpp —
* ``Scene.build`` == Scene::configure (scene.cpp:56-278): world-space
  triangle/edge arrays scatter-packed across meshes, emitter distribution,
  envmap bounding mesh, sensor primary-edge tables. It is a *pure function*
  of the parameter pytree, so ``jax.grad`` flows through geometry exactly as
  Enoki AD flows through the reference's re-configure();
* ``ray_intersect`` == Scene::ray_intersect (scene.cpp:289-384): detached
  closest-hit query + differentiable recompute in either the path-space
  (fixed barycentrics, J = A/detach(A)) or solid-angle (differentiable
  Moeller-Trumbore re-intersection) formulation;
* ``sample_emitter_position`` / ``emitter_position_pdf`` (scene.cpp:426-453);
* ``sample_boundary_segment_direct`` (scene.cpp:456-492).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import os

import numpy as np
import jax
import jax.numpy as jnp

from ..core.constants import Epsilon, EdgeEpsilon
from ..core.distribution import Discrete, discrete_init, discrete_sample_reuse
from ..core.frame import make_frame, to_local
from ..core.gather import gather_rows
from ..core.math import (bilinear, dot, norm, normalize, rgb2luminance,
                         safe_sqrt, sign_eps, squared_norm,
                         ray_intersect_triangle)
from ..core.records import (BoundarySegSample, Intersection, PositionSample,
                            Ray, RenderOptions)
from ..accel.bruteforce import HitRecord, ray_intersect_brute
from ..accel.bvh import (BVH, build_bvh_topology, ray_intersect_bvh,
                         ray_intersect_culled, refit_bvh)
from ..bsdf import Diffuse, RoughConductor
from ..emitter import AreaLight, EnvironmentMap
from ..emitter.envmap import (EnvmapState, configure_envmap,
                              envmap_eval_direction, envmap_position_pdf,
                              envmap_sample_position)
from ..sensor.perspective import (PerspectiveCamera, PrimaryEdgeInfo,
                                  SensorState, build_primary_edges,
                                  configure_sensor, finalize_primary_edges)
from ..shape.mesh import (Mesh, SecondaryEdgeInfo, TriangleInfo,
                          compute_sec_edge_info, compute_triangle_info,
                          sample_position)

sg = jax.lax.stop_gradient


class FlatScene(NamedTuple):
    """Flattened differentiable scene state (one pytree)."""
    tri: TriangleInfo            # (F,) world-space SoA
    uv0: jax.Array               # (F, 2) per-corner texture uv
    uv1: jax.Array
    uv2: jax.Array
    face_normal_mask: jax.Array  # (F,) bool — use face normals for shading
    mesh_id: jax.Array           # (F,) int32
    bsdf_id: jax.Array           # (F,) int32, -1 none
    emitter_id: jax.Array        # (F,) int32, -1 none
    sec_edge: SecondaryEdgeInfo  # (E,) stacked over meshes (E may be 0)
    sec_distrb: Discrete
    emitter_radiance: jax.Array  # (L, 3); zeros for non-area emitters
    emitter_weight: jax.Array    # (L,) normalized sampling weights
    emitter_inv_area: jax.Array  # (L,)
    emitter_distrb: Discrete
    emitter_face_distrb: tuple   # per-emitter Discrete over its mesh faces
    sensors: tuple               # SensorState per sensor
    bsdfs: tuple                 # per-bsdf param dicts
    envmap: Optional[EnvmapState]
    lower: jax.Array             # (3,) scene AABB
    upper: jax.Array
    accel: Optional[BVH] = None  # refit BVH; None -> brute force
    # "culled" (XLA block cull) | "pallas" (GPU kernel) | "bvh_walk"
    accel_kind: str = "culled"
    # (F, 32) packed per-face row table: every per-face field the recompute
    # gathers, concatenated so the hit recompute is ONE row gather instead
    # of 14 separate ones. Columns: p0 e1 e2 n0 n1 n2 fn | area |
    # uv0 uv1 uv2 | fmask | mesh_id bsdf_id emitter_id (ids as exact f32).
    face_table: Optional[jax.Array] = None
    # (E,) int32 global face ids of all emitter geometry (area-light faces +
    # envmap bounding mesh), or None when absent/too large — enables the
    # emitter-first bounce query (ray_intersect_emitter_first)
    em_tri_idx: Optional[jax.Array] = None
    # static flag set by detach_flat(): every array leaf is stop_gradient'd,
    # so ray_intersect skips the differentiable hit recompute (the kernel's
    # own t/uv are the same numbers) and narrows the face-table gather to
    # the shading columns
    detached: bool = False


def auto_accel_kind() -> str:
    """The ``"auto"`` intersection backend for the default JAX backend: the
    Triton-route kernel on a GPU, the XLA block-culled sweep elsewhere."""
    return "pallas" if jax.default_backend() == "gpu" else "culled"


def detach_flat(flat: "FlatScene") -> "FlatScene":
    """Stop-gradient every array leaf and mark the scene detached so the
    hit recompute takes its fast path. Use this instead of a bare tree-map
    wherever a detached render is intended (renderC, primary-edge deltas,
    guiding walks, detached far-side estimates)."""
    det = jax.tree.map(
        lambda x: jax.lax.stop_gradient(x) if isinstance(x, jax.Array) else x,
        flat)
    return det._replace(detached=True)


class Scene:
    """Host-side scene. Mirrors the reference's Python-facing Scene
    (src/psdr.cpp:268-280): load/configure/param_map plus object lists.
    """

    def __init__(self):
        self.meshes: list[Mesh] = []
        self.bsdfs: list = []
        self.emitters: list = []
        self.sensors: list[PerspectiveCamera] = []
        self._opts = RenderOptions()
        self.param_map: dict = {}
        self._configured = False
        self._flat_cache = None
        # ray-intersection backend: "auto" | "brute" | "culled" | "pallas"
        # | "bvh_walk". "auto" is ``auto_accel_kind()``. "bvh" is an alias
        # for "culled"; the per-ray pointer walk stays available as the
        # explicit "bvh_walk" for cross-checking, not as a production
        # dispatch target.
        self.accel_mode = "auto"
        self.accel_leaf_size = 4
        self.accel_min_faces = 512  # "auto" switches to BVH above this
        self._bvh_topo = None

    @property
    def opts(self) -> RenderOptions:
        return self._opts

    @opts.setter
    def opts(self, value: RenderOptions) -> None:
        # the cached FlatScene bakes in opts-dependent structure (edge
        # tables exist only when sppe/sppse > 0, sensor tables depend on
        # width/height), so any opts change must invalidate it
        self._opts = value
        self._flat_cache = None

    # -- construction --------------------------------------------------------
    def add_bsdf(self, bsdf, bsdf_id: str = "") -> int:
        self.bsdfs.append(bsdf)
        key = f"BSDF[id={bsdf_id}]" if bsdf_id else f"BSDF[{len(self.bsdfs)-1}]"
        if bsdf_id:
            bsdf.id = bsdf_id
        self.param_map[key] = bsdf
        return len(self.bsdfs) - 1

    def add_mesh(self, mesh: Mesh) -> int:
        self.meshes.append(mesh)
        self.param_map[f"Mesh[{len(self.meshes)-1}]"] = mesh
        return len(self.meshes) - 1

    def add_emitter(self, emitter) -> int:
        self.emitters.append(emitter)
        self.param_map[f"Emitter[{len(self.emitters)-1}]"] = emitter
        if isinstance(emitter, AreaLight):
            self.meshes[emitter.mesh_index].emitter_id = len(self.emitters) - 1
        return len(self.emitters) - 1

    def add_sensor(self, sensor: PerspectiveCamera) -> int:
        self.sensors.append(sensor)
        self.param_map[f"Sensor[{len(self.sensors)-1}]"] = sensor
        return len(self.sensors) - 1

    @property
    def num_sensors(self) -> int:
        return len(self.sensors)

    # -- reference-style loading entry points (psdr.cpp:271-272) -------------
    @staticmethod
    def load_file(fname: str, auto_configure: bool = True) -> "Scene":
        from .loader import load_file as _lf
        return _lf(fname, auto_configure)

    @staticmethod
    def load_string(xml: str, base_dir: str = ".") -> "Scene":
        from .loader import load_string as _ls
        return _ls(xml, base_dir)

    @property
    def envmap_index(self) -> int:
        for i, e in enumerate(self.emitters):
            if isinstance(e, EnvironmentMap):
                return i
        return -1

    # -- parameters -----------------------------------------------------------
    def params(self) -> dict:
        return {
            "meshes": [m.params() for m in self.meshes],
            "bsdfs": [b.params() for b in self.bsdfs],
            "emitters": [e.params() for e in self.emitters],
            "sensors": [s.params() for s in self.sensors],
        }

    def set_params(self, p: dict) -> None:
        for m, mp in zip(self.meshes, p["meshes"]):
            m.set_params(mp)
        for b, bp in zip(self.bsdfs, p["bsdfs"]):
            b.set_params(bp)
        for e, ep in zip(self.emitters, p["emitters"]):
            e.set_params(ep)
        for s, sp in zip(self.sensors, p["sensors"]):
            s.set_params(sp)
        self._flat_cache = None

    def _use_bvh(self) -> bool:
        total = sum(m.num_faces for m in self.meshes)
        return (self.accel_mode in ("bvh", "bvh_walk", "culled", "pallas")
                or (self.accel_mode == "auto"
                    and total >= self.accel_min_faces))

    def prepare_accel(self) -> None:
        """Host-side, concrete: build the static BVH topology (triangle
        Morton order + skip links) from the current geometry. Subsequent
        (possibly traced) ``build`` calls only refit AABBs."""
        if self._use_bvh() and self._bvh_topo is None:
            flat0 = self.build(self.params())
            self._bvh_topo = build_bvh_topology(
                np.asarray(flat0.tri.p0), np.asarray(flat0.tri.e1),
                np.asarray(flat0.tri.e2), leaf_size=self.accel_leaf_size)

    @staticmethod
    def _leaf_area(perm, leaf_size, p0, e1, e2):
        """Total surface area of the leaf AABBs induced by a triangle
        permutation — the cull-efficiency (SAH-like) cost of a topology."""
        L = leaf_size
        idx = np.maximum(perm, 0).reshape(-1, L)
        ok = (perm >= 0).reshape(-1, L)[..., None]
        v0 = p0[idx]
        pts = np.stack([v0, v0 + e1[idx], v0 + e2[idx]], axis=2)
        big = np.float32(1e30)
        lo = np.where(ok[:, :, None], pts, big).min(axis=(1, 2))
        hi = np.where(ok[:, :, None], pts, -big).max(axis=(1, 2))
        ext = np.maximum(hi - lo, 0.0)
        any_tri = ok[:, :, 0].any(axis=1)
        area = 2 * (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
                    + ext[:, 2] * ext[:, 0])
        return float(np.where(any_tri, area, 0.0).sum())

    def refit_quality(self, params: dict | None = None) -> float:
        """Ratio (>= ~1) of the current topology's refit leaf-AABB surface
        area to a fresh Morton build's, at the given (concrete) parameters.
        Morton order frozen at ``prepare_accel`` degrades under large
        deformation; a ratio well above 1 means rays sweep needlessly fat
        leaf boxes."""
        if self._bvh_topo is None:
            return 1.0
        flat = self.build(self.params() if params is None else params)
        p0 = np.asarray(flat.tri.p0)
        e1 = np.asarray(flat.tri.e1)
        e2 = np.asarray(flat.tri.e2)
        fresh = build_bvh_topology(p0, e1, e2,
                                   leaf_size=self.accel_leaf_size)
        cur = self._leaf_area(np.asarray(self._bvh_topo.perm),
                              self._bvh_topo.leaf_size, p0, e1, e2)
        ref = self._leaf_area(np.asarray(fresh.perm), fresh.leaf_size,
                              p0, e1, e2)
        return cur / max(ref, 1e-30)

    def maybe_rebuild_accel(self, params: dict | None = None,
                            threshold: float = 1.5) -> bool:
        """Host-side re-sort trigger: rebuild the Morton topology when the
        refit quality degraded past ``threshold`` (the OptiX analog is a
        full GAS rebuild instead of a refit). Call between optimizer steps;
        NOT inside jit. Returns True if the topology was rebuilt (the next
        jitted render retraces against the new static topology)."""
        if self._bvh_topo is None:
            return False
        if self.refit_quality(params) <= threshold:
            return False
        if params is not None:
            self.set_params(jax.tree.map(np.asarray, params))
        self._bvh_topo = None
        self._flat_cache = None
        self.prepare_accel()
        return True

    def configure(self) -> "FlatScene":
        """Build + cache the flat scene at the current parameters."""
        self.prepare_accel()
        self._flat_cache = self.build(self.params())
        self._configured = True
        return self._flat_cache

    @property
    def flat(self) -> "FlatScene":
        if self._flat_cache is None:
            self.configure()
        return self._flat_cache

    # -- the pure differentiable configure ------------------------------------
    def build(self, params: dict) -> FlatScene:
        assert self.meshes, "Missing meshes!"
        assert self.sensors, "Missing sensor!"
        # host scene objects keep leaves as numpy (no eager dispatches);
        # promote here so traced indexing works uniformly
        params = jax.tree.map(jnp.asarray, params)
        with_edges = self.opts.sppse > 0 or self.opts.sppe > 0

        # Per-mesh world geometry (mesh.cpp:215-274)
        world_vps = []
        tri_infos = []
        face_offset = [0]
        for mesh, mp in zip(self.meshes, params["meshes"]):
            vp = mesh.world_positions(mp)
            info, _ = compute_triangle_info(
                vp, jnp.asarray(mesh.faces), mesh.num_vertices)
            if mesh.use_vertex_normals:
                # authored vn channels override the recomputed area-weighted
                # shading normals (beyond reference; geometric normals and
                # edge silhouettes stay position-derived)
                n0, n1, n2 = mesh.world_shading_normals(mp)
                info = info._replace(n0=n0, n1=n1, n2=n2)
            world_vps.append(vp)
            tri_infos.append(info)
            face_offset.append(face_offset[-1] + mesh.num_faces)

        # scene AABB over detached vertices + camera positions
        # (scene.cpp:88-119)
        lows = [jnp.min(sg(vp), axis=0) for vp in world_vps]
        highs = [jnp.max(sg(vp), axis=0) for vp in world_vps]
        sensor_states = [configure_sensor(s, sp["to_world"],
                                          (self.opts.width, self.opts.height))
                         for s, sp in zip(self.sensors, params["sensors"])]
        lows += [sg(st.camera_pos) for st in sensor_states]
        highs += [sg(st.camera_pos) for st in sensor_states]
        lower = jnp.min(jnp.stack(lows), axis=0)
        upper = jnp.max(jnp.stack(highs), axis=0)

        # envmap + bounding mesh (scene.cpp:134-180)
        env_idx = self.envmap_index
        envmap = None
        bound_info = None
        if env_idx >= 0:
            margin = jnp.min((upper - lower) * 0.05)
            lower = lower - margin
            upper = upper + margin
            # host radiance snapshot (numpy on the Scene object) lets
            # configure_envmap freeze the O(1) alias importance table at
            # TRACE time — zero per-frame cost; unbiased even when the
            # snapshot lags optimized radiance params, because the stored
            # pdf always equals what the frozen table actually samples
            import numpy as _np
            _env_data = self.emitters[env_idx].radiance.data
            host_rad = (_np.asarray(_env_data)
                        if not isinstance(_env_data, jax.core.Tracer) else None)
            envmap = configure_envmap(params["emitters"][env_idx], lower, upper,
                                      host_radiance=host_rad)
            corners = jnp.stack(
                [jnp.stack([jnp.where(i & (1 << j), upper[j], lower[j])
                            for j in range(3)]) for i in range(8)])
            bound_faces = jnp.asarray(_BOUND_FACES, jnp.int32)
            bound_info, _ = compute_triangle_info(corners, bound_faces, 8)

        # global triangle arrays (scene.cpp:204-216)
        tri = jax.tree.map(lambda *xs: jnp.concatenate(xs), *tri_infos,
                           *( [bound_info] if bound_info is not None else [] ))
        uv0_l, uv1_l, uv2_l, fmask_l, mid_l, bid_l, eid_l = [], [], [], [], [], [], []
        for i, mesh in enumerate(self.meshes):
            nf = mesh.num_faces
            if mesh.uv is not None:
                uvs = jnp.asarray(mesh.uv)
                uvi = jnp.asarray(mesh.uv_idx, jnp.int32)
                uv0_l.append(uvs[uvi[:, 0]])
                uv1_l.append(uvs[uvi[:, 1]])
                uv2_l.append(uvs[uvi[:, 2]])
            else:
                z = jnp.zeros((nf, 2), jnp.float32)
                uv0_l.append(z); uv1_l.append(z); uv2_l.append(z)
            fmask_l.append(jnp.full((nf,), mesh.use_face_normals))
            mid_l.append(jnp.full((nf,), i, jnp.int32))
            bid_l.append(jnp.full((nf,), mesh.bsdf_id, jnp.int32))
            eid_l.append(jnp.full((nf,), mesh.emitter_id, jnp.int32))
        if bound_info is not None:
            z = jnp.zeros((12, 2), jnp.float32)
            uv0_l.append(z); uv1_l.append(z); uv2_l.append(z)
            fmask_l.append(jnp.full((12,), True))
            mid_l.append(jnp.full((12,), len(self.meshes), jnp.int32))
            bid_l.append(jnp.full((12,), -1, jnp.int32))
            eid_l.append(jnp.full((12,), env_idx, jnp.int32))

        # secondary-edge arrays (scene.cpp:218-244), masked not compacted
        sec_list = []
        for mesh, vp, info in zip(self.meshes, world_vps, tri_infos):
            if mesh.enable_edges and with_edges and mesh.edge_indices.shape[0]:
                sec_list.append(compute_sec_edge_info(vp, info, mesh.edge_indices))
        if sec_list:
            sec_edge = jax.tree.map(lambda *xs: jnp.concatenate(xs), *sec_list)
        else:
            z3 = jnp.zeros((1, 3), jnp.float32)
            sec_edge = SecondaryEdgeInfo(valid=jnp.zeros((1,), bool),
                                         is_boundary=jnp.zeros((1,), bool),
                                         p0=z3, e1=z3, n0=z3, n1=z3, p2=z3)
        sec_mass = jnp.where(sec_edge.valid, norm(sg(sec_edge.e1)), 0.0)
        sec_distrb = discrete_init(sec_mass)

        # emitters (scene.cpp:182-201)
        n_emitters = max(len(self.emitters), 1)
        radiance = jnp.zeros((n_emitters, 3), jnp.float32)
        inv_area = jnp.zeros((n_emitters,), jnp.float32)
        weights = []
        face_distrbs = []
        for i, em in enumerate(self.emitters):
            if isinstance(em, AreaLight):
                m = em.mesh_index
                fa = tri_infos[m].face_area
                total_area = jnp.sum(fa)
                rad = params["emitters"][i]["radiance"]
                radiance = radiance.at[i].set(rad)
                inv_area = inv_area.at[i].set(1.0 / total_area)
                weights.append(sg(total_area * rgb2luminance(sg(rad))))
                face_distrbs.append(discrete_init(sg(fa)))
            else:  # envmap: weight like reference default (envmap.h m_sampling_weight=1)
                weights.append(jnp.asarray(1.0, jnp.float32))
                face_distrbs.append(discrete_init(jnp.ones(1)))
        if not self.emitters:
            weights.append(jnp.asarray(1.0, jnp.float32))
            face_distrbs.append(discrete_init(jnp.ones(1)))
        w = jnp.stack(weights)
        emitter_distrb = discrete_init(w)
        emitter_weight = w / jnp.maximum(emitter_distrb.total, 1e-20)

        # sensors: primary-edge tables (perspective.cpp:39-111)
        if self.opts.sppe > 0:
            new_states = []
            for st in sensor_states:
                rows = []
                for mesh, vp, info in zip(self.meshes, world_vps, tri_infos):
                    if mesh.enable_edges and mesh.edge_indices.shape[0]:
                        rows.append(build_primary_edges(
                            st, vp, info, mesh.edge_indices,
                            mesh.use_face_normals))
                if rows:
                    stacked = PrimaryEdgeInfo(
                        valid=jnp.concatenate([r.valid for r in rows]),
                        p0=jnp.concatenate([r.p0 for r in rows]),
                        p1=jnp.concatenate([r.p1 for r in rows]),
                        edge_normal=jnp.concatenate([r.edge_normal for r in rows]),
                        edge_length=jnp.concatenate([r.edge_length for r in rows]),
                        distrb=rows[0].distrb)
                    st = st._replace(edges=finalize_primary_edges(stacked))
                new_states.append(st)
            sensor_states = new_states

        accel = None
        if (self._bvh_topo is not None
                and self._bvh_topo.num_faces == tri.p0.shape[0]):
            accel = refit_bvh(self._bvh_topo, tri.p0, tri.e1, tri.e2)

        # static emitter-face index set (mesh->emitter assignment is static)
        em_rows = [np.arange(face_offset[i], face_offset[i + 1],
                             dtype=np.int32)
                   for i, mesh in enumerate(self.meshes)
                   if mesh.emitter_id >= 0]
        if bound_info is not None:
            em_rows.append(np.arange(face_offset[-1], face_offset[-1] + 12,
                                     dtype=np.int32))
        em_tri_idx = None
        if em_rows:
            em_cat = np.concatenate(em_rows)
            # the emitter-first query sweeps these densely per bounce ray;
            # past a few thousand faces the full accel path wins again
            if em_cat.shape[0] <= 8192:
                em_tri_idx = jnp.asarray(em_cat)

        if tri.p0.shape[0] >= (1 << 24):
            # tri ids round-trip through f32 in the packed sorted-hit
            # un-permute (_closest_hit); 2^24 is where f32 stops being
            # integer-exact — fail loudly instead of corrupting ids
            raise ValueError("scenes with >= 2^24 faces are not supported")
        uv0 = jnp.concatenate(uv0_l)
        uv1 = jnp.concatenate(uv1_l)
        uv2 = jnp.concatenate(uv2_l)
        fmask = jnp.concatenate(fmask_l)
        mesh_id = jnp.concatenate(mid_l)
        bsdf_id = jnp.concatenate(bid_l)
        emitter_id = jnp.concatenate(eid_l)
        face_table = jnp.concatenate([
            tri.p0, tri.e1, tri.e2, tri.n0, tri.n1, tri.n2, tri.face_normal,
            tri.face_area[:, None], uv0, uv1, uv2,
            fmask.astype(jnp.float32)[:, None],
            mesh_id.astype(jnp.float32)[:, None],
            bsdf_id.astype(jnp.float32)[:, None],
            emitter_id.astype(jnp.float32)[:, None]], axis=1)

        self.face_offset = face_offset
        if self.accel_mode == "bvh":          # demoted alias (see __init__)
            accel_kind = "culled"
        elif self.accel_mode in ("bvh_walk", "pallas", "culled"):
            accel_kind = self.accel_mode
        else:
            accel_kind = auto_accel_kind()
        return FlatScene(
            accel=accel,
            accel_kind=accel_kind,
            tri=tri,
            uv0=uv0, uv1=uv1, uv2=uv2,
            face_normal_mask=fmask,
            mesh_id=mesh_id,
            bsdf_id=bsdf_id,
            emitter_id=emitter_id,
            face_table=face_table,
            sec_edge=sec_edge, sec_distrb=sec_distrb,
            emitter_radiance=radiance, emitter_weight=emitter_weight,
            emitter_inv_area=inv_area, emitter_distrb=emitter_distrb,
            emitter_face_distrb=tuple(face_distrbs),
            sensors=tuple(sensor_states),
            bsdfs=tuple(b_params for b_params in params["bsdfs"]),
            envmap=envmap, lower=lower, upper=upper,
            em_tri_idx=em_tri_idx)

    @property
    def bsdf_kinds(self):
        return tuple(b.kind for b in self.bsdfs)

    def __repr__(self):
        return ("Scene[\n  # Sensors\n  " + "\n  ".join(map(repr, self.sensors))
                + "\n  # BSDFs\n  " + "\n  ".join(map(repr, self.bsdfs))
                + "\n  # Meshes\n  " + "\n  ".join(map(repr, self.meshes)) + "\n]")


_BOUND_FACES = [
    [0, 1, 3], [0, 3, 2], [1, 5, 7], [1, 7, 3], [2, 3, 7], [2, 7, 6],
    [0, 5, 1], [0, 4, 5], [0, 2, 6], [0, 6, 4], [4, 7, 5], [4, 6, 7],
]


# -- device-side scene queries (pure functions over FlatScene) ---------------

# segmented-sort implementation: "argsort" (stable bitonic network) or
# "counting" (one-hot running count — no compare-exchange network; the
# 65-value key space makes a counting sort natural). Same (perm, inv)
# either way (tests/test_render.py pins equality); not yet measured
# against each other on the GPU.
_SORT_IMPL = os.environ.get("PSDR_TPU_SORT_IMPL", "argsort")


def _octant_sort(ray: Ray, active: jax.Array, seg: int = 1 << 15,
                 want_inv: bool = True, impl: str | None = None):
    """Stable within-segment reorder by quantized direction: groups lanes
    into 64 direction bins (4x4x4 per-component quantization) inside
    32k-lane segments, trading some origin (pixel-tile) coherence for much
    tighter direction cones per ray block. Inactive lanes sort to the end of
    each segment, so sparse wavefronts (e.g. the emitter-first occlusion
    sweep) compact their active lanes into few ray blocks and the rest exit
    at the cull phase. Returns (permutation, inverse permutation)."""
    impl = impl or _SORT_IMPL
    d = sg(ray.d)
    n = d.shape[0]
    s = seg if n % seg == 0 else 4096
    s = min(s, n)
    if n % s != 0:
        return None, None
    q = jnp.clip(((d + 1.0) * 2.0).astype(jnp.int32), 0, 3)
    key = q[:, 0] * 16 + q[:, 1] * 4 + q[:, 2]
    key = jnp.where(sg(active), key, 64)
    keys = key.reshape(n // s, s)
    base = (jnp.arange(n // s, dtype=jnp.int32) * s)[:, None]
    if impl == "counting":
        # stable counting sort over the 65 bins: each lane's sorted
        # position = its bin's exclusive offset + its rank within the
        # bin (running count). i16 suffices: ranks < 32768 = seg max
        oh = jax.nn.one_hot(keys, 65, dtype=jnp.int16)
        run = jnp.cumsum(oh, axis=1)
        hist = run[:, -1, :].astype(jnp.int32)
        offs = jnp.cumsum(hist, axis=1) - hist
        rank = jnp.take_along_axis(run, keys[..., None],
                                   axis=2)[..., 0].astype(jnp.int32) - 1
        pos = jnp.take_along_axis(offs, keys, axis=1) + rank
        inv = (pos + base).reshape(n)
        perm = jnp.zeros((n,), jnp.int32).at[inv].set(
            jnp.arange(n, dtype=jnp.int32))
        return perm, (inv if want_inv else None)
    local = jnp.argsort(keys, axis=1, stable=True).astype(jnp.int32)
    perm = (local + base).reshape(n)
    if not want_inv:
        return perm, None
    inv = jnp.zeros((n,), jnp.int32).at[perm].set(
        jnp.arange(n, dtype=jnp.int32))
    return perm, inv


def _closest_hit(flat: FlatScene, ray: Ray, active: jax.Array,
                 tmax=None, sort_rays: bool = False, any_hit: bool = False,
                 test_only: bool = False):
    """Backend dispatch for the detached closest-hit query.

    ``any_hit=True`` (occlusion queries) lets the Pallas backend return any
    hit inside [0, tmax) and terminate its triangle stream early once every
    lane is decided; other backends ignore it (their closest hit is also a
    valid any-hit answer).

    ``test_only=True`` returns just the (N,) hit boolean — the sorted path
    then un-permutes one bool (a single scatter) instead of building the
    inverse permutation and gathering the whole record back.
    """
    perm = inv = None
    q_o, q_d, q_act = ray.o, ray.d, active
    q_tmax = tmax
    if sort_rays and flat.accel is not None:
        perm, inv = _octant_sort(ray, active, want_inv=not test_only)
        if perm is not None:
            # permute via ONE packed row gather, not one per array
            packed = jnp.concatenate(
                [sg(ray.o), sg(ray.d), active.astype(jnp.float32)[:, None]]
                + ([sg(tmax)[:, None]] if tmax is not None else []), axis=1)
            packed = packed[perm]
            q_o, q_d = packed[:, 0:3], packed[:, 3:6]
            q_act = packed[:, 6] > 0.5
            if tmax is not None:
                q_tmax = packed[:, 7]
    if flat.accel is not None:
        if flat.accel_kind == "bvh_walk":
            hit = ray_intersect_bvh(flat.accel, q_o, q_d, q_act, tmax=q_tmax)
        elif flat.accel_kind == "pallas":
            from ..accel.pallas_kernel import ray_intersect_pallas
            hit = ray_intersect_pallas(flat.accel, q_o, q_d, q_act,
                                       tmax=q_tmax, any_hit=any_hit)
        else:
            hit = ray_intersect_culled(flat.accel, q_o, q_d, q_act,
                                       tmax=q_tmax)
    else:
        hit = ray_intersect_brute(flat.tri.p0, flat.tri.e1, flat.tri.e2,
                                  ray.o, ray.d, active, tmax=tmax)
    if test_only:
        if perm is None:
            return hit.valid
        return jnp.zeros(perm.shape, bool).at[perm].set(hit.valid)
    if perm is not None:
        # inverse permutation, also as one packed row gather; tri_id < 2^24
        # so it round-trips f32 exactly
        hp = jnp.concatenate(
            [hit.t[:, None], hit.uv,
             hit.tri_id.astype(jnp.float32)[:, None],
             hit.valid.astype(jnp.float32)[:, None]], axis=1)[inv]
        hit = HitRecord(valid=hp[:, 4] > 0.5,
                        tri_id=hp[:, 3].astype(jnp.int32),
                        uv=hp[:, 1:3], t=hp[:, 0])
    return hit


def ray_test(flat: FlatScene, ray: Ray, dist: jax.Array,
             active: jax.Array, sort_rays: bool = False,
             sparse: bool = False) -> jax.Array:
    """Occlusion query: True where some surface lies strictly closer than
    ``dist - ShadowEpsilon``. The tmax bound lets the block-culled backends
    prune every triangle block beyond the light — cheaper than the
    closest-hit + distance-compare the reference uses.

    ``sparse=True``: expect few active lanes (the emitter-first occlusion
    sweep runs at ~1% — only bounce rays that reach an emitter need the
    test) and run the kernel on a compacted 1/8-size wavefront when every
    sort segment's active count fits; an exact ``lax.cond`` falls back to
    the full sorted sweep when it doesn't: the full-size path would
    permute and scatter full-width arrays around a mostly-dead kernel."""
    from ..core.constants import ShadowEpsilon
    tmax = sg(dist) - ShadowEpsilon
    if sparse and flat.accel is not None and flat.accel_kind == "pallas":
        occ = _ray_test_sparse(flat, ray, tmax, active)
        if occ is not None:
            return occ & active
    occ = _closest_hit(flat, ray, active, tmax=tmax, any_hit=True,
                       sort_rays=sort_rays, test_only=True)
    return occ & active


def _ray_test_sparse(flat: FlatScene, ray: Ray, tmax: jax.Array,
                     active: jax.Array, frac_shift: int = 3,
                     seg: int = 1 << 15):
    """Compacted any-hit: segment-sort lanes by (active, octant), keep the
    first ``s >> frac_shift`` of each segment (a static strided slice — the
    sort puts active lanes there whenever the segment's active count fits),
    run the kernel on that 2^-frac_shift-size wavefront, scatter the bools
    back. Exactness is preserved by a ``lax.cond`` to the full sorted sweep
    when any segment overflows its slice. Returns None when the lane count
    doesn't factor into sort segments (caller falls back)."""
    n = ray.d.shape[0]
    s = seg if n % seg == 0 else 4096  # must mirror _octant_sort's sizing
    s = min(s, n)
    ks = s >> frac_shift
    if n % s != 0 or ks < 128:
        return None
    # _octant_sort keys by (active, direction octant) with inactive lanes
    # last, so the first ks sorted lanes of each segment hold every active
    # lane whenever the segment's count fits
    perm, _ = _octant_sort(ray, active, seg=seg, want_inv=False)
    if perm is None:
        return None
    perm_k = perm.reshape(n // s, s)[:, :ks].reshape(-1)
    counts = active.reshape(n // s, s).sum(axis=1)
    fits = jnp.max(counts) <= ks

    def sparse_path(_):
        packed = jnp.concatenate(
            [sg(ray.o), sg(ray.d), active.astype(jnp.float32)[:, None],
             sg(tmax)[:, None]], axis=1)[perm_k]
        q_act = packed[:, 6] > 0.5
        from ..accel.pallas_kernel import ray_intersect_pallas
        hit = ray_intersect_pallas(flat.accel, packed[:, 0:3],
                                   packed[:, 3:6], q_act, tmax=packed[:, 7],
                                   any_hit=True)
        return jnp.zeros((n,), bool).at[perm_k].set(hit.valid & q_act)

    def dense_path(_):
        return _closest_hit(flat, ray, active, tmax=tmax, any_hit=True,
                            sort_rays=True, test_only=True)

    return jax.lax.cond(fits, sparse_path, dense_path, None)


def ray_intersect_emitter_first(flat: FlatScene, ray: Ray, active: jax.Array,
                                sort_rays: bool = True,
                                want_tri_info: bool = False):
    """Closest hit restricted to emitter geometry, plus a tmax-bounded
    any-hit occlusion sweep of the full scene.

    Exact replacement for a full closest-hit wherever the caller consumes
    the hit only on emitter lanes (the reference's BSDF-sampled MIS term,
    direct.cpp:76-99): a bounce ray contributes iff its global closest hit
    lies on an emitter, i.e. iff the nearest emitter hit exists and nothing
    occludes it (same ShadowEpsilon convention as NEE's ray_test). The
    emitter face set is tiny (area-light faces + the envmap bounding mesh),
    so its closest hit is a cheap dense sweep, and the occlusion query is
    active only on the lanes that actually point at an emitter — replacing
    the incoherent full-scene closest hit that dominated the e2e forward
    (60% of frame time, round-2 stage bench).
    """
    idxs = flat.em_tri_idx
    hit_e = ray_intersect_brute(flat.tri.p0[idxs], flat.tri.e1[idxs],
                                flat.tri.e2[idxs], ray.o, ray.d, active)
    valid_e = hit_e.valid & active
    occluded = ray_test(flat, ray, jnp.where(valid_e, hit_e.t, 0.0),
                        valid_e, sort_rays=sort_rays, sparse=True)
    valid = valid_e & ~occluded
    hit = hit_e._replace(
        valid=valid,
        tri_id=jnp.where(valid, idxs[jnp.maximum(hit_e.tri_id, 0)], -1),
        t=jnp.where(valid, hit_e.t, jnp.inf))
    # the recompute only ever reads emitter-set rows here, so feed it rows
    # selected from the compact (E, 32) emitter slice of the face table —
    # a static select chain instead of a wavefront gather into (F, 32)
    rows = None
    if flat.face_table is not None and idxs.shape[0] <= 16:
        em_table = flat.face_table[idxs]
        rows = select_rows(em_table, jnp.maximum(hit_e.tri_id, 0))
    return ray_intersect(flat, ray, active, path_space=True, hit=hit,
                         rows=rows, want_tri_info=want_tri_info)


def ray_intersect(flat: FlatScene, ray: Ray, active: jax.Array,
                  path_space: bool = False, want_tri_info: bool = False,
                  sort_rays: bool = False, hit=None, rows=None):
    """Detached closest hit + differentiable recompute (scene.cpp:289-384).

    ``hit``: optional precomputed detached HitRecord (e.g. from the
    emitter-first query) — skips the closest-hit dispatch.
    ``rows``: optional pre-selected (N, 32) face-table rows matching
    ``hit.tri_id`` — skips the face-table gather."""
    if hit is None:
        hit = _closest_hit(flat, ray, active, sort_rays=sort_rays)
    valid = hit.valid & active
    idx = jnp.maximum(hit.tri_id, 0)

    if flat.detached and not want_tri_info:
        return _intersection_detached(flat, ray, hit, valid, idx, rows)

    if rows is not None or flat.face_table is not None:
        # one packed row gather instead of 14 separate table gathers;
        # the backward of this gather is the big (N,32)->(F,32)
        # scatter-add — gather_rows makes its reduction strategy
        # selectable (core/gather.py)
        if rows is None:
            rows = gather_rows(flat.face_table, idx)
        tri = TriangleInfo(
            p0=rows[:, 0:3], e1=rows[:, 3:6], e2=rows[:, 6:9],
            n0=rows[:, 9:12], n1=rows[:, 12:15], n2=rows[:, 15:18],
            face_normal=rows[:, 18:21], face_area=rows[:, 21])
        uv0g, uv1g, uv2g = rows[:, 22:24], rows[:, 24:26], rows[:, 26:28]
        fmask = rows[:, 28] > 0.5
        mesh_id_g = rows[:, 29].astype(jnp.int32)
        bsdf_id_g = rows[:, 30].astype(jnp.int32)
        emitter_id_g = rows[:, 31].astype(jnp.int32)
    else:
        tri = jax.tree.map(lambda a: a[idx], flat.tri)
        fmask = flat.face_normal_mask[idx]
        uv0g, uv1g, uv2g = flat.uv0[idx], flat.uv1[idx], flat.uv2[idx]
        mesh_id_g = flat.mesh_id[idx]
        bsdf_id_g = flat.bsdf_id[idx]
        emitter_id_g = flat.emitter_id[idx]

    if path_space:
        uv = sg(hit.uv)
        p = bilinear(tri.p0, tri.e1, tri.e2, uv)
        # miss lanes gather triangle 0; if the ray origin sits on it, the
        # norm() below has a NaN gradient at 0 — park dead lanes at o + d
        p = jnp.where(valid[..., None], p, sg(ray.o + ray.d))
        d = p - ray.o
        # sqrt(max(., eps)) instead of norm(): a grazing hit whose
        # barycentric recompute rounds to p == o (a kernel may accept
        # t ~ RayEpsilon hits that another backend rejects)
        # would otherwise put sqrt's 0/0 NaN gradient on the lane — and
        # 0-cotangent * NaN poisons the whole psum into the camera matrix
        t = jnp.sqrt(jnp.maximum(squared_norm(d), 1e-16))
        d = d / t[..., None]
        wi_world = -d
        J = tri.face_area / sg(tri.face_area)
    else:
        uv, t = ray_intersect_triangle(tri.p0, tri.e1, tri.e2, ray.o, ray.d)
        # Keep the recompute FINITE on every lane: with a caller-provided
        # ``hit`` (known-triangle camera trace) a vis=True lane can be
        # near-coplanar, and its unclamped t ~ 1e20 / uv ~ 1e20 would turn
        # into inf/NaN in downstream normalize()/bilinear() squares —
        # 0-cotangent * NaN still poisons the psum'd gradient.
        # True hits have t far below 1e6 (f32 geometry is unusable beyond
        # that) and uv in [0,1], so the clamps never bind (and pass
        # gradients through) on geometrically real lanes; 1e6-scale masked
        # garbage stays finite through downstream squares/normalizes.
        t = jnp.clip(t, -1e6, 1e6)
        uv = jnp.clip(uv, -8.0, 8.0)
        # miss lanes recompute against the gathered triangle 0 with a near-
        # singular 1/a factor; park them at t=1 so no 1e20-scale positions
        # (and their catastrophic float32 cancellations) enter later bounces
        t = jnp.where(valid, t, 1.0)
        uv = jnp.where(valid[..., None], uv, 0.0)
        p = ray.at(t)
        wi_world = -ray.d
        J = jnp.ones_like(t)

    sh_n = normalize(bilinear(tri.n0, tri.n1 - tri.n0, tri.n2 - tri.n0, uv))
    sh_n = jnp.where(fmask[..., None], tri.face_normal, sh_n)
    frame = make_frame(sh_n)
    uv_tex = bilinear(uv0g, uv1g - uv0g, uv2g - uv0g, uv)

    its = Intersection(
        valid=valid, t=t, p=p, n=tri.face_normal, sh_frame=frame,
        uv=uv_tex, wi=to_local(frame, wi_world), J=J,
        mesh_id=mesh_id_g, tri_id=hit.tri_id,
        bsdf_id=jnp.where(valid, bsdf_id_g, -1),
        emitter_id=jnp.where(valid, emitter_id_g, -1))
    if want_tri_info:
        return its, tri
    return its


def _intersection_detached(flat: FlatScene, ray: Ray, hit, valid, idx,
                           rows=None) -> Intersection:
    """Detached-scene hit record: the kernel's own (t, uv) ARE the answer
    (the differentiable Möller-Trumbore recompute reproduces them up to
    ulps, so with gradients stopped it is pure redundant work), and only
    the shading columns [9:32] of the face table are needed — the p0/e1/e2
    columns exist solely to re-derive what the kernel already returned.
    Identical estimator up to fp round-off in both formulations: the
    solid-angle t equals the kernel t, and the path-space
    p = bilinear(p0,e1,e2, uv) equals ray.at(t) at the same barycentrics;
    J = 1 exactly once gradients are stopped."""
    t = jnp.where(valid, hit.t, 1.0)
    uv = jnp.where(valid[..., None], hit.uv, 0.0)
    p = ray.at(t)

    if rows is not None:
        sub = rows[:, 9:]
    elif flat.face_table is not None:
        sub = gather_rows(flat.face_table[:, 9:], idx)
    else:
        sub = None
    if sub is not None:
        n0 = sub[:, 0:3]
        n1, n2 = sub[:, 3:6], sub[:, 6:9]
        face_n = sub[:, 9:12]
        uv0g, uv1g, uv2g = sub[:, 13:15], sub[:, 15:17], sub[:, 17:19]
        fmask = sub[:, 19] > 0.5
        mesh_id_g = sub[:, 20].astype(jnp.int32)
        bsdf_id_g = sub[:, 21].astype(jnp.int32)
        emitter_id_g = sub[:, 22].astype(jnp.int32)
    else:
        n0, n1, n2 = flat.tri.n0[idx], flat.tri.n1[idx], flat.tri.n2[idx]
        face_n = flat.tri.face_normal[idx]
        fmask = flat.face_normal_mask[idx]
        uv0g, uv1g, uv2g = flat.uv0[idx], flat.uv1[idx], flat.uv2[idx]
        mesh_id_g = flat.mesh_id[idx]
        bsdf_id_g = flat.bsdf_id[idx]
        emitter_id_g = flat.emitter_id[idx]

    sh_n = normalize(bilinear(n0, n1 - n0, n2 - n0, uv))
    sh_n = jnp.where(fmask[..., None], face_n, sh_n)
    frame = make_frame(sh_n)
    uv_tex = bilinear(uv0g, uv1g - uv0g, uv2g - uv0g, uv)
    return Intersection(
        valid=valid, t=t, p=p, n=face_n, sh_frame=frame,
        uv=uv_tex, wi=to_local(frame, -ray.d), J=jnp.ones_like(t),
        mesh_id=mesh_id_g, tri_id=hit.tri_id,
        bsdf_id=jnp.where(valid, bsdf_id_g, -1),
        emitter_id=jnp.where(valid, emitter_id_g, -1))


def ray_intersect_with_prior(flat: FlatScene, ray: Ray, active: jax.Array,
                             prior=None):
    """Camera closest hit accelerated by a per-lane hit prior (see
    RenderOptions.camera_hit_prior). ``prior`` is the detached tuple
    ``(tmax_bound, cand_tri_id, cand_uv, cand_t, cand_ok)`` built by the
    interior renderer from the pixel-center pre-trace: where the lane's ray
    hits its candidate triangle at t0, ``tmax_bound = t0(1+eps)`` bounds the
    query (any real hit is an upper bound on the closest t, so the bounded
    query is EXACT); elsewhere the bound is +inf. Lanes where the kernel's
    own arithmetic rejects the candidate by an ulp and finds nothing else
    inside the bound are rescued with the candidate hit itself."""
    if prior is None:
        return ray_intersect(flat, ray, active)
    tmax_b, cand_tri, cand_uv, cand_t, cand_ok = prior
    hit = _closest_hit(flat, ray, active, tmax=tmax_b)
    resc = active & cand_ok & ~hit.valid
    hit = HitRecord(valid=hit.valid | resc,
                    tri_id=jnp.where(resc, cand_tri, hit.tri_id),
                    uv=jnp.where(resc[..., None], cand_uv, hit.uv),
                    t=jnp.where(resc, cand_t, hit.t))
    return ray_intersect(flat, ray, active, hit=hit)


def select_rows(table: jax.Array, idx: jax.Array,
                max_unroll: int = 16) -> jax.Array:
    """``table[idx]`` for a small static first dimension, as a static
    select chain: L compares + selects fuse into the consumer, where a
    wavefront-sized gather would be one more pass. Falls back to a real gather when the
    table is large. ``table``: (L, ...); ``idx``: (N,) int32."""
    L = table.shape[0]
    if L > max_unroll:
        return table[idx]
    expand = (slice(None),) + (None,) * (table.ndim - 1)
    out = jnp.broadcast_to(table[0], idx.shape + table.shape[1:])
    for i in range(1, L):
        out = jnp.where((idx == i)[expand], table[i], out)
    return out


def scene_le(flat: FlatScene, its: Intersection, active: jax.Array) -> jax.Array:
    """Emitted radiance toward the viewer at a hit (intersection.h Le +
    area.cpp:20-29 one-sidedness; env hits via the bounding mesh)."""
    active = active & its.is_emitter()
    eid = jnp.maximum(its.emitter_id, 0)
    front = its.wi[..., 2] > 0.0
    le = jnp.where((active & front)[..., None],
                   select_rows(flat.emitter_radiance, eid), 0.0)
    if flat.envmap is not None:
        from ..core.frame import to_world as frame_to_world
        wi_world = frame_to_world(its.sh_frame, its.wi)
        env_mask = active & (its.bsdf_id < 0)
        le = jnp.where(env_mask[..., None],
                       envmap_eval_direction(flat.envmap, -wi_world, env_mask),
                       le)
    return le


def sample_emitter_position(flat: FlatScene, face_offsets, emitter_meta,
                            ref_p: jax.Array, sample2: jax.Array,
                            active: jax.Array) -> PositionSample:
    """Pick an emitter ∝ weight, then sample its surface (scene.cpp:426-447).

    ``emitter_meta``: static list of ('area', mesh_index) / ('env', -1).
    """
    n = ref_p.shape[0]
    if len(emitter_meta) == 1:
        idx = jnp.zeros((n,), jnp.int32)
        sel_pdf = jnp.ones((n,), jnp.float32)
        s2 = sample2
    else:
        idx, sel_pdf, sy = discrete_sample_reuse(flat.emitter_distrb,
                                                 sample2[..., 1])
        s2 = jnp.stack([sample2[..., 0], sy], axis=-1)

    out = PositionSample(valid=jnp.zeros((n,), bool),
                         pdf=jnp.zeros((n,), jnp.float32),
                         p=jnp.zeros((n, 3), jnp.float32),
                         n=jnp.zeros((n, 3), jnp.float32),
                         J=jnp.ones((n,), jnp.float32),
                         emitter=jnp.full((n,), -1, jnp.int32))
    for i, (kind, mesh_index) in enumerate(emitter_meta):
        mask = active & (idx == i)
        if kind == "area":
            lo, hi = face_offsets[mesh_index], face_offsets[mesh_index + 1]
            tri_slice = jax.tree.map(lambda a: a[lo:hi], flat.tri)
            ps = sample_position(tri_slice, flat.emitter_face_distrb[i],
                                 flat.emitter_inv_area[i], s2)
        else:
            ps = envmap_sample_position(flat.envmap, ref_p, s2, mask)
        eid = i if kind == "area" else -1
        out = PositionSample(
            valid=jnp.where(mask, ps.valid, out.valid),
            pdf=jnp.where(mask, ps.pdf, out.pdf),
            p=jnp.where(mask[..., None], ps.p, out.p),
            n=jnp.where(mask[..., None], ps.n, out.n),
            J=jnp.where(mask, ps.J, out.J),
            emitter=jnp.where(mask, eid, out.emitter))
    return out._replace(pdf=out.pdf * sel_pdf,
                        valid=out.valid & active)


def emitter_position_pdf(flat: FlatScene, emitter_meta, ref_p: jax.Array,
                         its: Intersection, active: jax.Array) -> jax.Array:
    """Area-measure pdf of hitting this emitter point via light sampling
    (scene.cpp:450-453 + area.cpp:60-64 / envmap.cpp:120-139).
    Uses the *normalized* sampling weights (scene.cpp:192-195)."""
    active = active & its.is_emitter()
    eid = jnp.maximum(its.emitter_id, 0)
    env_w = select_rows(flat.emitter_weight, eid)
    pdf = env_w * select_rows(flat.emitter_inv_area, eid)
    pdf = jnp.where(active, pdf, 0.0)
    if flat.envmap is not None:
        env_mask = active & (its.bsdf_id < 0)
        env_pdf = envmap_position_pdf(flat.envmap, ref_p, its.p, its.n, env_mask)
        pdf = jnp.where(env_mask, env_w * env_pdf, pdf)
    return pdf


def sample_boundary_segment_direct(flat: FlatScene, face_offsets, emitter_meta,
                                   sample3: jax.Array,
                                   active: jax.Array) -> BoundarySegSample:
    """Sample (edge point p0, emitter point p2) for the direct boundary
    integral (scene.cpp:456-492)."""
    edge_idx, pdf0, s1 = discrete_sample_reuse(flat.sec_distrb, sample3[..., 0])
    se = flat.sec_edge
    packed = jnp.concatenate(
        [se.p0, se.e1, se.n0, se.n1, se.p2,
         se.valid.astype(jnp.float32)[:, None],
         se.is_boundary.astype(jnp.float32)[:, None],
         flat.sec_distrb.pmf[:, None]], axis=1)[edge_idx]
    info = SecondaryEdgeInfo(
        p0=packed[:, 0:3], e1=packed[:, 3:6], n0=packed[:, 6:9],
        n1=packed[:, 9:12], p2=packed[:, 12:15],
        valid=packed[:, 15] > 0.5, is_boundary=packed[:, 16] > 0.5)
    ok = info.valid & (packed[:, 17] > 0.0)

    p0 = info.p0 + info.e1 * s1[..., None]           # differentiable
    edge = normalize(sg(info.e1))
    edge2 = sg(info.p2) - sg(info.p0)
    p0_det = sg(p0)
    pdf0 = pdf0 / jnp.maximum(norm(sg(info.e1)), 1e-20)

    ps2 = sample_emitter_position(flat, face_offsets, emitter_meta,
                                  p0_det, sample3[..., 1:3], active)
    ps2 = jax.tree.map(sg, ps2)

    e = ps2.p - p0_det
    dist_sqr = squared_norm(e)
    e = e / safe_sqrt(dist_sqr)[..., None]
    cos_theta = dot(ps2.n, -e)

    sgn0 = sign_eps(dot(sg(info.n0), e), EdgeEpsilon)
    sgn1 = sign_eps(dot(sg(info.n1), e), EdgeEpsilon)
    boundary = sg(info.is_boundary)
    valid = (active & ok & ps2.valid & (cos_theta > Epsilon)
             & jnp.where(boundary, sgn0 != 0, sgn0 * sgn1 < 0))
    pdf = jnp.where(valid, pdf0 * ps2.pdf * dist_sqr / cos_theta, 0.0)
    return BoundarySegSample(valid=valid, p0=p0, edge=edge, edge2=edge2,
                             p2=ps2.p, n=ps2.n, pdf=pdf)
