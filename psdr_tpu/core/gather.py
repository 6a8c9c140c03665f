"""Wavefront row gather with a configurable transpose (backward).

The transpose of ``table[idx]`` (idx: N wavefront lanes, table: F rows) is
a scatter-add of N cotangent rows into F table rows (atomic adds on a
GPU, which contend on duplicate indices) — and the hit-recompute face-table
gather funnels every interior-lane cotangent through it. The sorted modes
below reorder the cotangent rows by destination first, turning the
reduction into a sorted segment sum or a cumsum difference.

Built on ``jax.custom_derivatives.linear_call`` (the gather is linear in
``table``), so BOTH autodiff modes work: the jvp of a linear function is
the function itself (tangents take the same gather), and the reverse-mode
transpose is the selectable reduction. A ``jax.custom_vjp`` formulation
would break the repo's jvp-based AD-vs-FD harness (testing/harness.py
``run_ad``).

Parity note: the reference accumulates these gradients with CUDA atomics
(enoki ``scatter_add``, e.g. src/core/bitmap.cpp grads); here the
question is which XLA lowering to force.

Modes
-----
- ``native``: plain ``table[idx]`` — XLA's own gather transpose (default
  until the on-chip A/B says otherwise).
- ``scatter``: explicit ``zeros.at[idx].add(ct)`` (same lowering as
  native; exists so the A/B has a named baseline).
- ``sorted``: argsort lanes by destination row, then
  ``segment_sum(..., indices_are_sorted=True)``.
- ``cumsum``: argsort, exclusive-padded cumsum, per-row difference at
  segment bounds — no scatter at all, but float32 prefix-sum association
  error grows with N (validated to 2e-3 tolerance at 2^16 lanes in
  tests/test_core.py; expect it to grow ~sqrt(N) beyond that).
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
from jax.custom_derivatives import linear_call

_MODES = ("native", "scatter", "sorted", "cumsum")
# env override so benches / the driver can flip the default without code
# edits (validated in set_gather_vjp_mode's caller path on first use)
_default_mode = os.environ.get("PSDR_TPU_GATHER_VJP", "native")


def set_gather_vjp_mode(mode: str) -> None:
    """Set the process-wide default backward mode (trace-time static)."""
    global _default_mode
    if mode not in _MODES:
        raise ValueError(f"gather vjp mode {mode!r} not in {_MODES}")
    _default_mode = mode


def get_gather_vjp_mode() -> str:
    return _default_mode


def _resolve(mode: str | None) -> str:
    mode = mode or _default_mode
    if mode not in _MODES:
        raise ValueError(f"gather vjp mode {mode!r} not in {_MODES}")
    return mode


def _sorted_reduce(mode: str, idx_s, ct_s, F: int):
    """Reduce already-sorted cotangent rows into (F, ...) table rows."""
    if mode == "sorted":
        return jax.ops.segment_sum(ct_s, idx_s, num_segments=F,
                                   indices_are_sorted=True)
    # cumsum: exclusive-padded prefix sum, difference at segment bounds
    csum = jnp.concatenate(
        [jnp.zeros((1,) + ct_s.shape[1:], ct_s.dtype),
         jnp.cumsum(ct_s, axis=0)], axis=0)
    rows = jnp.arange(F, dtype=idx_s.dtype)
    left = jnp.searchsorted(idx_s, rows, side="left")
    right = jnp.searchsorted(idx_s, rows, side="right")
    return csum[right] - csum[left]


def _transpose_one(mode: str, idx, ct, F: int):
    """Cotangent rows (lane-shaped) -> (F, ...) table gradient."""
    row_shape = ct.shape[idx.ndim:]
    ct = ct.reshape((-1,) + row_shape)
    idx = idx.reshape(-1)
    if mode == "scatter":
        return jnp.zeros((F,) + row_shape, ct.dtype).at[idx].add(ct)
    order = jnp.argsort(idx).astype(jnp.int32)
    return _sorted_reduce(mode, idx[order], ct[order], F)


def gather_rows(table: jax.Array, idx: jax.Array,
                mode: str | None = None) -> jax.Array:
    """``table[idx]`` whose backward reduction strategy is selectable.

    ``mode=None`` reads the process default (``set_gather_vjp_mode``) at
    trace time; jit caching is per-traced-program, so flip the default
    before tracing, not between calls of a compiled function.
    """
    mode = _resolve(mode)
    if mode == "native":
        return table[idx]
    F = table.shape[0]
    return linear_call(lambda r, t: t[r],
                       lambda r, ct: _transpose_one(mode, r, ct, F),
                       idx, table)


def gather_rows_offsets(table: jax.Array, idx: jax.Array,
                        offsets: tuple[int, ...],
                        mode: str | None = None) -> tuple[jax.Array, ...]:
    """``tuple(table[idx + o] for o in offsets)`` sharing ONE backward
    sort: adding a constant preserves sorted order, so every offset's
    cotangent reduction reuses the argsort of ``idx`` (the bitmap
    bilinear quad would otherwise pay 4 argsorts of near-identical
    index arrays)."""
    mode = _resolve(mode)
    if mode == "native":
        return tuple(table[idx + o] for o in offsets)
    F = table.shape[0]

    def fwd(r, t):
        return tuple(t[r + o] for o in offsets)

    def transpose(r, cts):
        if mode == "scatter":
            d = jnp.zeros(table.shape, cts[0].dtype)
            for o, ct in zip(offsets, cts):
                d = d.at[(r + o).reshape(-1)].add(
                    ct.reshape((-1,) + ct.shape[r.ndim:]))
            return d
        rf = r.reshape(-1)
        order = jnp.argsort(rf).astype(jnp.int32)
        idx_s = rf[order]
        d = None
        for o, ct in zip(offsets, cts):
            ct_s = ct.reshape((-1,) + ct.shape[r.ndim:])[order]
            part = _sorted_reduce(mode, idx_s + o, ct_s, F)
            d = part if d is None else d + part
        return d

    return linear_call(fwd, transpose, idx, table)
