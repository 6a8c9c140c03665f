"""Triangle meshes: host-side topology (OBJ load, edge adjacency) and the
differentiable world-space geometry pipeline.

Parity reference: psdr-cuda src/shape/mesh.cpp —
* ``load_obj``/``build_edges`` mirror Mesh::load (mesh.cpp:62-212) incl. the
  2-manifold edge-adjacency map with boundary edges flagged ``face1 = -1``;
* ``compute_triangle_info`` mirrors ``process_mesh`` (mesh.cpp:19-51):
  area-weighted vertex normals + world-space per-face SoA;
* ``compute_sec_edge_info`` mirrors Mesh::configure's SecondaryEdgeInfo build
  (mesh.cpp:251-263) with the dihedral filter as a *mask* instead of stream
  compaction (static shapes for XLA).

Host topology is numpy; everything entering gradients is JAX.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..core.constants import EdgeEpsilon
from ..core import transform as xform
from ..core.math import bilinear, cross, norm, normalize
from ..core.records import PositionSample
from ..core.distribution import Discrete, discrete_init, discrete_sample_reuse
from ..core import warp


class TriangleInfo(NamedTuple):
    """World-space per-face SoA (types.h:135-158 TriangleInfo_)."""
    p0: jax.Array           # (F, 3)
    e1: jax.Array           # (F, 3)
    e2: jax.Array           # (F, 3)
    n0: jax.Array           # (F, 3) vertex normals
    n1: jax.Array
    n2: jax.Array
    face_normal: jax.Array  # (F, 3) unit
    face_area: jax.Array    # (F,)


class SecondaryEdgeInfo(NamedTuple):
    """Per-edge silhouette-candidate data (edge/edge.h:49-67).

    ``valid`` replaces the reference's compaction: invalid rows get zero
    sampling weight.
    """
    valid: jax.Array        # (E,) bool  (dihedral filter & enable_edges)
    is_boundary: jax.Array  # (E,) bool  (open edge: single adjacent face)
    p0: jax.Array           # (E, 3) first endpoint
    e1: jax.Array           # (E, 3) p1 - p0
    n0: jax.Array           # (E, 3) adjacent face 0 normal
    n1: jax.Array           # (E, 3) adjacent face 1 normal (n0 where boundary)
    p2: jax.Array           # (E, 3) opposite vertex of face 0


def compute_triangle_info(vertex_positions: jax.Array, faces: jax.Array,
                          num_vertices: int):
    """Differentiable per-face SoA + area-weighted vertex normals.

    Parity: mesh.cpp:19-51 process_mesh.
    """
    p0 = vertex_positions[faces[:, 0]]
    p1 = vertex_positions[faces[:, 1]]
    p2 = vertex_positions[faces[:, 2]]
    e1 = p1 - p0
    e2 = p2 - p0

    fn = cross(e1, e2)
    fa = norm(fn)

    vn = jnp.zeros((num_vertices, 3), vertex_positions.dtype)
    vw = jnp.zeros((num_vertices,), vertex_positions.dtype)
    for i in range(3):
        vn = vn.at[faces[:, i]].add(fn)
        vw = vw.at[faces[:, i]].add(fa)
    vn = normalize(vn / jnp.maximum(vw, 1e-20)[:, None])

    info = TriangleInfo(
        p0=p0, e1=e1, e2=e2,
        n0=vn[faces[:, 0]], n1=vn[faces[:, 1]], n2=vn[faces[:, 2]],
        face_normal=fn / jnp.maximum(fa, 1e-20)[:, None],
        face_area=fa * 0.5,
    )
    return info, vn


def compute_sec_edge_info(vertex_positions: jax.Array,
                          tri_info: TriangleInfo,
                          edge_indices: np.ndarray) -> SecondaryEdgeInfo:
    """World-space silhouette-candidate edges (mesh.cpp:251-263)."""
    ei = jnp.asarray(edge_indices, jnp.int32)
    is_boundary = ei[:, 3] < 0
    f1 = jnp.maximum(ei[:, 3], 0)
    p0 = vertex_positions[ei[:, 0]]
    e1 = vertex_positions[ei[:, 1]] - p0
    n0 = tri_info.face_normal[ei[:, 2]]
    n1 = jnp.where(is_boundary[:, None], n0, tri_info.face_normal[f1])
    p2 = vertex_positions[ei[:, 4]]
    # dihedral filter: drop edges whose adjacent faces are (nearly) coplanar
    keep = jnp.sum(n0 * n1, axis=-1) < 1.0 - EdgeEpsilon
    keep = jnp.logical_or(keep, is_boundary)
    return SecondaryEdgeInfo(valid=keep, is_boundary=is_boundary,
                             p0=p0, e1=e1, n0=n0, n1=n1, p2=p2)


class Mesh:
    """Host-side mesh: static topology + differentiable parameter leaves.

    Differentiable parameters (returned by :meth:`params`):
      * ``vertex_positions`` — raw (object-space) positions, (V, 3)
      * ``to_world`` — 4x4 object-to-world matrix
      * ``vertex_offset`` — optional (V,) scalar displacement along the raw
        area-weighted vertex normals, applied *before* ``to_world``
        (parity: the reference's ``PSDR_MESH_ENABLE_1D_VERTEX_OFFSET`` mode,
        macros.h:12, mesh.h:71-81, mesh.cpp:226-229 — a compile-time flag
        there, a per-mesh runtime flag here). One scalar per vertex instead
        of three keeps normal-direction shape optimization from sliding
        vertices tangentially.
    """

    def __init__(self, vertices: np.ndarray, faces: np.ndarray,
                 uv: Optional[np.ndarray] = None,
                 uv_idx: Optional[np.ndarray] = None,
                 use_face_normals: bool = False,
                 enable_edges: bool = True,
                 enable_vertex_offset: bool = False,
                 normals: Optional[np.ndarray] = None,
                 normal_idx: Optional[np.ndarray] = None,
                 use_vertex_normals: bool = False,
                 bsdf_id: int = -1, emitter_id: int = -1,
                 mesh_id: str = ""):
        self.vertices = np.ascontiguousarray(vertices, np.float32)
        self.faces = np.ascontiguousarray(faces, np.int32)
        self.uv = None if uv is None else np.ascontiguousarray(uv, np.float32)
        self.uv_idx = (None if uv_idx is None
                       else np.ascontiguousarray(uv_idx, np.int32))
        self.use_face_normals = bool(use_face_normals)
        # authored OBJ vn channels (beyond reference: psdr-cuda's
        # tinyobjloader parses vn but mesh.cpp always recomputes
        # area-weighted normals; opt in with use_vertex_normals=True)
        self.normals = (None if normals is None
                        else np.ascontiguousarray(normals, np.float32))
        self.normal_idx = (None if normal_idx is None
                           else np.ascontiguousarray(normal_idx, np.int32))
        self.use_vertex_normals = bool(use_vertex_normals)
        if self.use_vertex_normals:
            if (self.normals is None or self.normal_idx is None
                    or (self.normal_idx < 0).any()):
                raise ValueError(
                    "use_vertex_normals=True requires the OBJ to carry vn "
                    "channels on every face corner (v//n or v/t/n forms)")
        self.enable_edges = bool(enable_edges)
        self.bsdf_id = int(bsdf_id)
        self.emitter_id = int(emitter_id)
        self.id = mesh_id

        self.num_vertices = int(self.vertices.shape[0])
        self.num_faces = int(self.faces.shape[0])
        self.edge_indices = (build_edges(self.faces) if enable_edges
                             else np.zeros((0, 5), np.int32))

        # differentiable leaves (initial values); kept as host numpy until
        # they cross a jit boundary (no eager device transfers)
        self.vertex_positions = self.vertices
        self.enable_vertex_offset = bool(enable_vertex_offset)
        self.vertex_offset = (np.zeros((self.num_vertices,), np.float32)
                              if self.enable_vertex_offset else None)
        self.to_world = np.eye(4, dtype=np.float32)
        # static outer factors, for append_transform-style composition
        # (mesh.h:19-35: to_world = left * raw * right)
        self.to_world_left = np.eye(4, dtype=np.float32)
        self.to_world_right = np.eye(4, dtype=np.float32)

    # -- parameter-pytree plumbing ------------------------------------------
    def params(self) -> dict:
        p = {"vertex_positions": self.vertex_positions,
             "to_world": self.to_world}
        if self.enable_vertex_offset:
            p["vertex_offset"] = self.vertex_offset
        return p

    def set_params(self, p: dict) -> None:
        self.vertex_positions = p["vertex_positions"]
        self.to_world = p["to_world"]
        if self.enable_vertex_offset and "vertex_offset" in p:
            self.vertex_offset = p["vertex_offset"]

    def set_transform(self, mat) -> None:
        self.to_world = np.asarray(mat, np.float32)

    def append_transform(self, mat) -> None:
        self.to_world_left = np.asarray(mat, np.float32) @ self.to_world_left

    def world_positions(self, params: dict) -> jax.Array:
        m = xform.matmul(xform.matmul(self.to_world_left, params["to_world"]),
                         self.to_world_right)
        vp = params["vertex_positions"]
        off = params.get("vertex_offset")
        if off is not None:
            # 1D vertex-offset mode (mesh.cpp:226-229): displace raw
            # positions along the *raw* area-weighted vertex normals before
            # the world transform. Normals are a differentiable function of
            # the raw positions, exactly as in the reference.
            _, vn = compute_triangle_info(vp, self.faces, self.num_vertices)
            vp = vp + off[:, None] * vn
        return xform.transform_pos(m, vp)

    def world_shading_normals(self, params: dict):
        """Per-corner world-space shading normals from the authored vn
        channels: rows transform by the inverse-transpose of the composite
        to_world linear part (differentiable in to_world; the raw normals
        are constants — authored data, not a function of positions)."""
        m = xform.matmul(xform.matmul(jnp.asarray(self.to_world_left),
                                      params["to_world"]),
                         jnp.asarray(self.to_world_right))
        n = xform.matmul(jnp.asarray(self.normals), jnp.linalg.inv(m[:3, :3]))
        n = n / jnp.maximum(
            jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
        ni = self.normal_idx
        return n[ni[:, 0]], n[ni[:, 1]], n[ni[:, 2]]

    def shift_vertices(self) -> None:
        """Bake the current (detached) offset into the raw positions and
        reset it to zero (mesh.cpp:346-351 Mesh::shift_vertices) — call
        between optimization epochs to re-anchor the offset parameterization.
        """
        if not self.enable_vertex_offset:
            return
        vp = np.asarray(self.vertex_positions, np.float32)
        off = np.asarray(self.vertex_offset, np.float32)
        self.vertex_positions = vp + off[:, None] * _vertex_normals_np(
            vp, self.faces)
        self.vertex_offset = np.zeros((self.num_vertices,), np.float32)

    # -- IO ------------------------------------------------------------------
    def dump(self, fname: str) -> None:
        """Write current raw geometry back to OBJ (mesh.cpp:354-418); any
        pending vertex offset is baked into the written positions
        (mesh.cpp:356-359)."""
        vp = np.asarray(self.vertex_positions, np.float32)
        if self.enable_vertex_offset:
            off = np.asarray(self.vertex_offset, np.float32)
            vp = vp + off[:, None] * _vertex_normals_np(vp, self.faces)
        with open(fname, "w") as f:
            for i in range(self.num_vertices):
                f.write("v %.6e %.6e %.6e\n" % (vp[i, 0], vp[i, 1], vp[i, 2]))
            if self.uv is not None:
                for i in range(self.uv.shape[0]):
                    f.write("vt %.6e %.6e\n" % (self.uv[i, 0], self.uv[i, 1]))
            for i in range(self.num_faces):
                a, b, c = (int(v) + 1 for v in self.faces[i])
                if self.uv_idx is not None:
                    ta, tb, tc = (int(v) + 1 for v in self.uv_idx[i])
                    f.write(f"f {a}/{ta} {b}/{tb} {c}/{tc}\n")
                else:
                    f.write(f"f {a} {b} {c}\n")

    def __repr__(self):
        return (f"Mesh[nv={self.num_vertices}, nf={self.num_faces}"
                + (f", id={self.id}" if self.id else "") + "]")


def _vertex_normals_np(vp: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Host-side area-weighted vertex normals (numpy twin of
    :func:`compute_triangle_info`'s normal pass, for offset baking)."""
    p0, p1, p2 = vp[faces[:, 0]], vp[faces[:, 1]], vp[faces[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    fa = np.linalg.norm(fn, axis=-1)
    vn = np.zeros_like(vp)
    vw = np.zeros((vp.shape[0],), vp.dtype)
    for i in range(3):
        np.add.at(vn, faces[:, i], fn)
        np.add.at(vw, faces[:, i], fa)
    vn = vn / np.maximum(vw, 1e-20)[:, None]
    return vn / np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-20)


def build_edges(faces: np.ndarray) -> np.ndarray:
    """Edge-adjacency table (E, 5): [v0, v1, face0, face1|-1, opp_vertex0].

    Enforces 2-manifoldness like mesh.cpp:143-203. Uses the C++ native
    builder when available; numpy grouping otherwise.
    """
    from .. import native
    out = native.build_edges(faces)
    if out is not None:
        return out
    f = faces.astype(np.int64)
    n_faces = f.shape[0]
    # all directed half-edges with their face + opposite vertex
    a = np.concatenate([f[:, 0], f[:, 1], f[:, 2]])
    b = np.concatenate([f[:, 1], f[:, 2], f[:, 0]])
    opp = np.concatenate([f[:, 2], f[:, 0], f[:, 1]])
    face = np.tile(np.arange(n_faces), 3)

    lo = np.minimum(a, b)
    hi = np.maximum(a, b)
    nv = int(f.max()) + 1 if n_faces else 0
    key = lo * nv + hi
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    face_s = face[order]
    opp_s = opp[order]
    lo_s, hi_s = lo[order], hi[order]

    uniq, start, counts = np.unique(key_s, return_index=True, return_counts=True)
    if np.any(counts > 2):
        raise ValueError("Non-manifold mesh: edge shared by more than 2 faces")

    e = uniq.shape[0]
    out = np.empty((e, 5), np.int32)
    out[:, 0] = lo_s[start]
    out[:, 1] = hi_s[start]
    out[:, 2] = face_s[start]
    out[:, 4] = opp_s[start]
    second = np.where(counts == 2, face_s[np.minimum(start + 1, key_s.shape[0] - 1)], -1)
    out[:, 3] = second.astype(np.int32)
    dup = (counts == 2) & (out[:, 2] == out[:, 3])
    if np.any(dup):
        raise ValueError("Duplicated faces sharing an edge")
    return out


def load_obj(fname: str, **kwargs) -> Mesh:
    """OBJ parser (v / vt / f with v, v/t, v//n, v/t/n forms).

    Replaces the reference's vendored tinyobjloader (mesh.cpp:62-141).
    Uses the C++ native parser when available; Python line loop otherwise.
    """
    from .. import native
    parsed = native.obj_load(fname) if native.available() else None
    if parsed is not None:
        verts_np, faces_np, uvs_np, fuvs_np, nrm_np, fnrm_np = parsed
        return Mesh(verts_np, faces_np, uv=uvs_np, uv_idx=fuvs_np,
                    normals=nrm_np, normal_idx=fnrm_np, **kwargs)

    verts: list = []
    uvs: list = []
    nrms: list = []
    f_v: list = []
    f_t: list = []
    f_n: list = []
    has_uv_face = False
    has_nrm_face = False
    with open(fname) as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif line.startswith("vt "):
                parts = line.split()
                uvs.append((float(parts[1]), float(parts[2])))
            elif line.startswith("vn "):
                parts = line.split()
                nrms.append((float(parts[1]), float(parts[2]),
                             float(parts[3])))
            elif line.startswith("f "):
                parts = line.split()[1:]
                idx = []
                tdx = []
                ndx = []
                for p in parts:
                    comp = p.split("/")
                    v = int(comp[0])
                    idx.append(v - 1 if v > 0 else len(verts) + v)
                    if len(comp) > 1 and comp[1]:
                        t = int(comp[1])
                        tdx.append(t - 1 if t > 0 else len(uvs) + t)
                        has_uv_face = True
                    else:
                        tdx.append(0)
                    if len(comp) > 2 and comp[2]:
                        nn = int(comp[2])
                        ndx.append(nn - 1 if nn > 0 else len(nrms) + nn)
                        has_nrm_face = True
                    else:
                        ndx.append(-1)  # no vn on this corner
                # triangulate fans
                for k in range(1, len(idx) - 1):
                    f_v.append((idx[0], idx[k], idx[k + 1]))
                    f_t.append((tdx[0], tdx[k], tdx[k + 1]))
                    f_n.append((ndx[0], ndx[k], ndx[k + 1]))

    vertices = np.asarray(verts, np.float32)
    faces = np.asarray(f_v, np.int32)
    uv = np.asarray(uvs, np.float32) if (uvs and has_uv_face) else None
    uv_idx = np.asarray(f_t, np.int32) if uv is not None else None
    use_n = bool(nrms) and has_nrm_face
    normals = np.asarray(nrms, np.float32) if use_n else None
    normal_idx = np.asarray(f_n, np.int32) if use_n else None
    return Mesh(vertices, faces, uv=uv, uv_idx=uv_idx,
                normals=normals, normal_idx=normal_idx, **kwargs)


def sample_position(tri_info: TriangleInfo, face_distrb: Discrete,
                    inv_total_area: jax.Array, sample2: jax.Array) -> PositionSample:
    """Uniform area sampling of a mesh with reparam Jacobian J
    (mesh.cpp:305-330).
    """
    idx, _, sx = discrete_sample_reuse(face_distrb, sample2[..., 0])
    st = warp.square_to_uniform_triangle(
        jnp.stack([sx, sample2[..., 1]], axis=-1))
    # one packed row gather instead of 5 separate table gathers
    packed = jnp.concatenate(
        [tri_info.p0, tri_info.e1, tri_info.e2, tri_info.face_normal,
         tri_info.face_area[:, None]], axis=1)[idx]
    fa = packed[:, 12]
    p = bilinear(packed[:, 0:3], packed[:, 3:6], packed[:, 6:9], st)
    J = fa / jax.lax.stop_gradient(fa)
    return PositionSample(
        valid=jnp.ones(idx.shape, bool),
        pdf=jnp.broadcast_to(inv_total_area, idx.shape),
        p=p,
        n=packed[:, 9:12],
        J=J,
    )
