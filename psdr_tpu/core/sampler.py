"""Random-sample streams.

The reference (psdr-cuda src/core/sampler.cpp) uses a vectorized PCG32 with
per-lane TEA-hashed seeds and three independent streams owned by the scene
(interior / primary-edge / secondary-edge). Here we use JAX's counter-based
PRNG instead: a stream is a base key, and every draw folds a trace-time
static counter into it, so the whole render remains a pure function of the
key with no mutable state threading.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


class RngStream:
    """Trace-time helper: each ``.next_*`` call derives a fresh subkey by
    folding an incrementing *static* counter into the base key. Safe inside
    ``jit`` because the counter advances at trace time only.
    """

    def __init__(self, key: jax.Array, salt: int | None = None):
        self.key = jax.random.fold_in(key, salt) if salt is not None else key
        self._i = 0

    def _subkey(self) -> jax.Array:
        k = jax.random.fold_in(self.key, self._i)
        self._i += 1
        return k

    def next_1d(self, shape) -> jax.Array:
        if isinstance(shape, int):
            shape = (shape,)
        return jax.random.uniform(self._subkey(), shape, dtype=jnp.float32)

    def next_2d(self, n: int) -> jax.Array:
        return self.next_1d((n, 2))

    def next_3d(self, n: int) -> jax.Array:
        return self.next_1d((n, 3))

    def next_nd(self, n: int, d: int) -> jax.Array:
        return self.next_1d((n, d))


def make_streams(seed: int, n: int = 3) -> list[jax.Array]:
    """The scene's independent sampler streams (scene.cpp:23, 64-79)."""
    return list(jax.random.split(jax.random.PRNGKey(seed), n))


# -- low-discrepancy (0,2)-sequence (beyond-reference sample quality) --------
#
# Van der Corput + Larcher-Pillichshammer pair: every prefix of the
# sequence equidistributes over ALL base-2 elementary intervals, strictly
# stronger than an a x b stratification at power-of-two sample counts.
# XOR (digit) scrambling preserves the elementary-interval property while
# decorrelating pixels, so per-pixel scramble words give an unbiased
# randomized-QMC estimator (tests/test_core.py pins both properties).
# All uint32 bit math — VPU-native, no gathers, no tables.

# precomputed Larcher-Pillichshammer column vectors: v_{k+1} = v_k ^ (v_k >> 1)
_LP_V = []
_v = 1 << 31
for _ in range(32):
    _LP_V.append(_v)
    _v ^= _v >> 1
del _v


def _bit_reverse32(x: jax.Array) -> jax.Array:
    x = ((x & jnp.uint32(0x55555555)) << 1) | ((x >> 1) & jnp.uint32(0x55555555))
    x = ((x & jnp.uint32(0x33333333)) << 2) | ((x >> 2) & jnp.uint32(0x33333333))
    x = ((x & jnp.uint32(0x0F0F0F0F)) << 4) | ((x >> 4) & jnp.uint32(0x0F0F0F0F))
    x = ((x & jnp.uint32(0x00FF00FF)) << 8) | ((x >> 8) & jnp.uint32(0x00FF00FF))
    return (x << 16) | (x >> 16)


def _lp32(n: jax.Array) -> jax.Array:
    x = jnp.zeros_like(n)
    for k in range(32):
        x = jnp.where((n >> k) & 1 == 1, x ^ jnp.uint32(_LP_V[k]), x)
    return x


def ld_2d(index: jax.Array, scramble_x: jax.Array,
          scramble_y: jax.Array) -> jax.Array:
    """Scrambled (0,2)-sequence point for each ``index`` (uint32/int32);
    ``scramble_*`` are per-lane (or broadcastable) uint32 scramble words.
    Returns (..., 2) float32 in [0, 1)."""
    i = index.astype(jnp.uint32)
    x = _bit_reverse32(i) ^ scramble_x.astype(jnp.uint32)
    y = _lp32(i) ^ scramble_y.astype(jnp.uint32)
    inv = jnp.float32(2.3283064365386963e-10)  # 2^-32
    return jnp.stack([x.astype(jnp.float32) * inv,
                      y.astype(jnp.float32) * inv], axis=-1)
