"""Differentiable textures (constant or bilinearly-interpolated images).

Parity reference: psdr-cuda src/core/bitmap.cpp (Bitmap<1,3>::eval with uv
wraparound and edge clamping to resolution-2, bilinear weights) — the data
layout here is a dense (H, W, C) jnp array; C is 1 or 3.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .gather import gather_rows, gather_rows_offsets


class Bitmap(NamedTuple):
    """data shape (H, W, C). (1, 1, C) means a constant texture."""
    data: jax.Array

    @property
    def resolution(self):
        return (self.data.shape[1], self.data.shape[0])  # (width, height)

    @property
    def channels(self) -> int:
        return self.data.shape[2]


def constant(value, channels: int | None = None) -> Bitmap:
    """Host-side constructor: keeps data as numpy until a jit boundary."""
    import numpy as np
    v = np.atleast_1d(np.asarray(value, np.float32))
    if channels is not None and v.shape[0] != channels:
        v = np.broadcast_to(v, (channels,))
    return Bitmap(data=v.reshape(1, 1, -1))


def from_array(arr) -> Bitmap:
    """Host-side constructor: keeps data as numpy until a jit boundary."""
    import numpy as np
    if isinstance(arr, (jnp.ndarray,)) and not isinstance(arr, np.ndarray):
        arr = jnp.asarray(arr, jnp.float32)
    else:
        arr = np.asarray(arr, np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    return Bitmap(data=arr)


def eval_bitmap(bm: Bitmap, uv: jax.Array, flip_v: bool = False) -> jax.Array:
    """Evaluate at uv (..., 2); returns (..., C). Differentiable in both
    ``bm.data`` and ``uv``. Parity: bitmap.cpp:42-89.
    """
    h, w, c = bm.data.shape
    if h == 1 and w == 1:
        return jnp.broadcast_to(bm.data[0, 0], uv.shape[:-1] + (c,))

    u = uv[..., 0]
    v = uv[..., 1]
    if flip_v:
        v = -v
    u = u - jnp.floor(u)
    v = v - jnp.floor(v)
    # scale by (reso - 1), like the reference (no half-texel offset)
    x = u * (w - 1)
    y = v * (h - 1)
    x0 = jnp.minimum(jnp.floor(x).astype(jnp.int32), w - 2)
    y0 = jnp.minimum(jnp.floor(y).astype(jnp.int32), h - 2)
    wx1 = x - x0.astype(x.dtype)
    wy1 = y - y0.astype(y.dtype)
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1

    if h * w <= (1 << 20):
        # one packed quad-row gather instead of 4 separate texel gathers
        # (the shifted-view concat is one O(HW) copy that XLA CSEs across eval
        # sites). The roll wrap rows are never read: x0 <= w-2, y0 <= h-2.
        flat = bm.data.reshape(h * w, c)
        quad = jnp.concatenate([flat,
                                jnp.roll(flat, -1, axis=0),
                                jnp.roll(flat, -w, axis=0),
                                jnp.roll(flat, -(w + 1), axis=0)], axis=1)
        rows = gather_rows(quad, y0 * w + x0)
        v00, v10 = rows[..., 0:c], rows[..., c:2 * c]
        v01, v11 = rows[..., 2 * c:3 * c], rows[..., 3 * c:4 * c]
    else:
        # huge bitmaps (4k envmaps): the 4x quad copy (+ its same-shaped
        # backward cotangent) risks HBM blowup, so keep separate gathers
        # (offsets variant: their backwards share one cotangent sort)
        flatd = bm.data.reshape(h * w, c)
        v00, v10, v01, v11 = gather_rows_offsets(
            flatd, y0 * w + x0, (0, 1, w, w + 1))

    v0 = wx0[..., None] * v00 + wx1[..., None] * v10
    v1 = wx0[..., None] * v01 + wx1[..., None] * v11
    return wy0[..., None] * v0 + wy1[..., None] * v1
