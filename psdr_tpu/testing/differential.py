"""Scalar-parameter scene perturbations for AD/FD validation.

Parity reference: psdr-cuda examples/utils/differential.py:5-35 — each mode
maps a scalar P to a perturbed parameter pytree, so a *forward-mode*
derivative image d(image)/dP can be compared against central finite
differences. Modes: mesh_transform (rigid translate), mesh_rotate,
vertex_transform (single-vertex displacement), material_roughness,
envmap_rotate.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import Scene
from ..core import transform as xf


def _per_mesh(params: dict, mesh_index, vecs, update) -> dict:
    """Apply ``update(mesh_params, vec) -> new to_world`` to one or several
    meshes (the reference's configs drive lists of Mesh_IDs,
    examples/utils/differential.py:5-20)."""
    idxs = mesh_index if isinstance(mesh_index, (list, tuple)) else [mesh_index]
    vecs = list(vecs) if isinstance(vecs[0], (list, tuple)) else [vecs] * len(idxs)
    out = dict(params)
    out["meshes"] = list(params["meshes"])
    for i, v in zip(idxs, vecs):
        new = dict(out["meshes"][i])
        new["to_world"] = update(new, jnp.asarray(v, jnp.float32))
        out["meshes"][i] = new
    return out


def mesh_transform(params: dict, P, *, mesh_index=0,
                   direction=(1.0, 0.0, 0.0)) -> dict:
    return _per_mesh(params, mesh_index, direction,
                     lambda m, d: xf.matmul(xf.translate(d * P),
                                             m["to_world"]))


def mesh_rotate(params: dict, P, *, mesh_index=0,
                axis=(0.0, 1.0, 0.0)) -> dict:
    # axis direction carries the sign; xf.rotate normalizes magnitude
    return _per_mesh(params, mesh_index, axis,
                     lambda m, a: xf.matmul(xf.rotate(a, P),
                                             m["to_world"]))


def vertex_transform(params: dict, P, *, mesh_index: int = 0,
                     vertex_index: int = 0, direction=(0.0, 1.0, 0.0)) -> dict:
    d = jnp.asarray(direction, jnp.float32)
    m = params["meshes"][mesh_index]
    new = dict(m)
    vp = jnp.asarray(m["vertex_positions"])  # scene params may be host numpy
    new["vertex_positions"] = vp.at[vertex_index].add(d * P)
    out = dict(params)
    out["meshes"] = list(params["meshes"])
    out["meshes"][mesh_index] = new
    return out


def material_roughness(params: dict, P, *, bsdf_index: int = 0) -> dict:
    b = params["bsdfs"][bsdf_index]
    new = dict(b)
    new["alpha_u"] = b["alpha_u"] + P
    new["alpha_v"] = b["alpha_v"] + P
    out = dict(params)
    out["bsdfs"] = list(params["bsdfs"])
    out["bsdfs"][bsdf_index] = new
    return out


def envmap_rotate(params: dict, P, *, emitter_index: int = 0,
                  axis=(0.0, 1.0, 0.0)) -> dict:
    e = params["emitters"][emitter_index]
    new = dict(e)
    new["to_world"] = xf.matmul(
        xf.rotate(jnp.asarray(axis, jnp.float32), P), e["to_world"])
    out = dict(params)
    out["emitters"] = list(params["emitters"])
    out["emitters"][emitter_index] = new
    return out


PERTURBATIONS = {
    "mesh_transform": mesh_transform,
    "mesh_rotate": mesh_rotate,
    "vertex_transform": vertex_transform,
    "material_roughness": material_roughness,
    "envmap_rotate": envmap_rotate,
}


def apply_perturbation(kind: str, params: dict, P, **kwargs) -> dict:
    return PERTURBATIONS[kind](params, P, **kwargs)
