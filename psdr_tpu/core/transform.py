"""Homogeneous 4x4 transforms (column-vector convention, like Enoki).

Parity reference: psdr-cuda include/psdr/core/transform.h. Matrices act on
column vectors: ``p' = M @ [p, 1]``; batched helpers accept point arrays of
shape (..., 3).

Backend-generic builders: given plain Python/numpy inputs they compute with
numpy on the host (no eager device dispatches); given jax arrays/tracers
(e.g. a traced rotation angle in a perturbation) they trace with jnp.
Traced matrix products run at full float32 precision (``matmul``): a GPU
may otherwise execute them in TF32, whose ~1e-3 relative error would move
hit points and break the brute-force parity and AD-vs-FD checks.
"""
from __future__ import annotations

import math

import numpy as np
import jax
import jax.numpy as jnp


def _backend(*xs):
    for x in xs:
        for leaf in jax.tree.leaves(x):
            if isinstance(leaf, (jax.Array, jax.core.Tracer)):
                return jnp
    return np


def translate(v):
    m = _backend(v)
    v = m.asarray(v, m.float32)
    eye = m.eye(4, dtype=m.float32)
    if m is np:
        out = eye.copy()
        out[:3, 3] = v
        return out
    return eye.at[:3, 3].set(v)


def scale(v):
    m = _backend(v)
    v = m.asarray(v, m.float32)
    return m.diag(m.concatenate([v, m.ones(1, m.float32)]))


def rotate(axis, angle_deg):
    """Rotation about an arbitrary axis; angle in degrees (transform.h:26-28)."""
    m = _backend(axis, angle_deg)
    axis = m.asarray(axis, m.float32)
    axis = axis / m.maximum(m.sqrt(m.sum(axis * axis)), 1e-20)
    theta = m.deg2rad(m.asarray(angle_deg, m.float32))
    s, c = m.sin(theta), m.cos(theta)
    x, y, z = axis[0], axis[1], axis[2]
    C = 1.0 - c
    r = m.array([
        [x * x * C + c,     x * y * C - z * s, x * z * C + y * s, 0.0],
        [y * x * C + z * s, y * y * C + c,     y * z * C - x * s, 0.0],
        [z * x * C - y * s, z * y * C + x * s, z * z * C + c,     0.0],
        [0.0, 0.0, 0.0, 1.0],
    ], dtype=m.float32)
    return r


def perspective(fov_deg: float, near: float, far: float):
    """Maps [near, far] on +z to [0, 1]; fov mapped to [-1, 1]
    (transform.h:30-58)."""
    recip = 1.0 / (far - near)
    cot = 1.0 / math.tan(math.radians(fov_deg * 0.5))
    m = np.diag(np.array([cot, cot, far * recip, 0.0], np.float32))
    m[2, 3] = -near * far * recip
    m[3, 2] = 1.0
    return m


def look_at(origin, target, up):
    """Camera-to-world: columns = [left, new_up, dir, origin]
    (transform.h:60-78)."""
    m = _backend(origin, target, up)
    origin = m.asarray(origin, m.float32)
    target = m.asarray(target, m.float32)
    up = m.asarray(up, m.float32)

    def unit(v):
        return v / m.maximum(m.sqrt(m.sum(v * v)), 1e-20)

    dir_ = unit(target - origin)
    left = unit(m.cross(up, dir_))
    new_up = m.cross(dir_, left)
    mat = m.stack([left, new_up, dir_, origin], axis=-1)  # (3, 4)
    bottom = m.array([[0.0, 0.0, 0.0, 1.0]], m.float32)
    return m.concatenate([mat, bottom], axis=0)


def matmul(a, b):
    """``a @ b``: numpy on numpy inputs, else a float32-exact jnp product
    (``Precision.HIGHEST``, never TF32)."""
    if _backend(a, b) is np:
        return np.asarray(a) @ np.asarray(b)
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def transform_pos(mat, p):
    """Apply M to points p (..., 3) with perspective divide."""
    tmp = matmul(p, mat[:3, :3].T) + mat[:3, 3]
    w = matmul(p, mat[3, :3]) + mat[3, 3]
    return tmp / w[..., None]


def transform_dir(mat, d):
    """Apply M's linear part to directions d (..., 3) (no divide)."""
    return matmul(d, mat[:3, :3].T)


def inverse(mat):
    return _backend(mat).linalg.inv(mat)
