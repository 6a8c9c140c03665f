"""Discrete and hypercube sampling distributions.

Parity reference: psdr-cuda src/core/pmf.cpp (DiscreteDistribution with
``sample_reuse``) and src/core/cube_distrb.cpp (HyperCubeDistribution<2,3>).

Everything is a static-shape pytree so distributions can live inside jitted
scene state; gradients never flow through sampling (sampling uses detached
masses, exactly like the reference which builds them from detached arrays).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class Discrete(NamedTuple):
    """Unnormalized pmf + inclusive cmf (pmf.cpp:7-14)."""
    pmf: jax.Array   # (n,)
    cmf: jax.Array   # (n,) inclusive prefix sum
    total: jax.Array  # scalar = cmf[-1]

    @property
    def size(self) -> int:
        return self.pmf.shape[0]


def discrete_init(pmf: jax.Array) -> Discrete:
    pmf = jax.lax.stop_gradient(pmf)
    # XLA's parallel-scan cumsum is not guaranteed monotone at f32 rounding
    # level even for non-negative pmf (observed ~1e-7-relative dips at 300k
    # entries); binary search / block counts over a non-monotone cmf are
    # ill-defined at the dips, so clamp with a running max.
    cmf = jax.lax.cummax(jnp.cumsum(pmf))
    return Discrete(pmf=pmf, cmf=cmf, total=cmf[-1])


def discrete_sample_reuse(d: Discrete, samples: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Sample indices ∝ pmf and remap the used samples back to [0, 1).

    Returns (idx, pdf_normalized, samples_remapped). Parity: pmf.cpp:29-50.

    Small tables (emitter selection, small area-light face tables) use a
    broadcast compare + masked reductions instead of searchsorted + gathers:
    the L-wide compare row fuses with its consumers where each
    wavefront-sized gather is a pass of its own. Both branches compute identical
    values (the reductions select actual table entries, no re-derivation).
    """
    s = samples * d.total
    if d.size <= 32:
        lt = d.cmf[None, :] < s[..., None]                   # (N, L)
        idx = jnp.sum(lt, axis=-1, dtype=jnp.int32)
        idx = jnp.clip(idx, 0, d.size - 1)
        # select cmf[idx-1] / pmf[idx] by INDEX (static select chains), not
        # by masked max over values: XLA's parallel-scan cumsum is not
        # guaranteed monotone at f32 rounding level, so a value-based max
        # can pick a different entry than searchsorted's cmf[idx-1]
        prev = jnp.zeros_like(s)
        pmf_i = jnp.broadcast_to(d.pmf[0], idx.shape)
        for i in range(1, d.size):
            prev = jnp.where(idx == i, d.cmf[i - 1], prev)
            pmf_i = jnp.where(idx == i, d.pmf[i], pmf_i)
    elif d.size <= (1 << 25):
        # blocked broadcast search (2 or 3 levels of 128): count block-end
        # cmf entries below s at the top level (broadcast, no gathers),
        # then one packed row gather + in-row count per lower level.
        # searchsorted lowers to log2(n) dependent wavefront gathers; this
        # is 1-2 row gathers + one pmf gather + compare
        # rows. All selected values are actual table entries; prev entries
        # are selected by INDEX (see small-branch comment on cumsum
        # monotonicity).
        C = 128
        n_blocks = -(-d.size // C)
        pad = n_blocks * C - d.size
        cmf_rows = jnp.pad(d.cmf, (0, pad),
                           constant_values=jnp.inf).reshape(n_blocks, C)
        # end value of the last real block is cmf[-1] (pad is +inf): fix it
        scmf = cmf_rows[:, -1].at[-1].set(d.cmf[-1])

        def count_and_prev(row_or_table, lt_row):
            """(#entries < s per lane, value at index count-1) for a (N, C)
            compare row; the prev select is by index."""
            r = jnp.sum(lt_row, axis=-1, dtype=jnp.int32)
            r = jnp.clip(r, 0, lt_row.shape[-1] - 1)
            iota = jnp.arange(lt_row.shape[-1], dtype=jnp.int32)
            prev_v = jnp.sum(jnp.where(iota[None, :] == (r - 1)[..., None],
                                       row_or_table, 0.0), axis=-1)
            return r, prev_v

        if n_blocks <= 2048:
            blk_row = jnp.broadcast_to(scmf[None, :],
                                       s.shape + (n_blocks,))
            blk, prev_blk = count_and_prev(blk_row, scmf[None, :] < s[..., None])
            blk = jnp.clip(blk, 0, n_blocks - 1)
        else:
            # 3 levels: top blocks of 128 block-ends
            B2 = -(-n_blocks // C)
            pad2 = B2 * C - n_blocks
            scmf_rows = jnp.pad(scmf, (0, pad2),
                                constant_values=jnp.inf).reshape(B2, C)
            scmf2 = scmf_rows[:, -1].at[-1].set(d.cmf[-1])
            top_row = jnp.broadcast_to(scmf2[None, :], s.shape + (B2,))
            b2, prev_b2 = count_and_prev(top_row, scmf2[None, :] < s[..., None])
            b2 = jnp.clip(b2, 0, B2 - 1)
            mid = scmf_rows[b2]                              # (N, C)
            b1, prev_b1 = count_and_prev(mid, mid < s[..., None])
            blk = jnp.clip(b2 * C + b1, 0, n_blocks - 1)
            prev_blk = jnp.where(b1 > 0, prev_b1, prev_b2)
        import os as _os
        if _os.environ.get("PSDR_TPU_CMF_PACKED", "1") == "1":
            # pack the pmf row next to the cmf row: ONE (N, 2C) row gather
            # replaces (N, C) + a separate (N,) pmf gather into the big
            # table (not yet A/B'd on the GPU). The
            # in-row pmf select is exact: padded entries are 0 but s <
            # total keeps idx inside the real range (cmf pad is +inf).
            pmf_rows = jnp.pad(d.pmf, (0, pad)).reshape(n_blocks, C)
            row2 = jnp.concatenate([cmf_rows, pmf_rows], axis=1)[blk]
            row = row2[:, :C]
            r, prev_in = count_and_prev(row, row < s[..., None])
            idx = jnp.clip(blk * C + r, 0, d.size - 1)
            prev = jnp.where(r > 0, prev_in, prev_blk)
            iota = jnp.arange(C, dtype=jnp.int32)
            pmf_i = jnp.sum(jnp.where(iota[None, :] == r[..., None],
                                      row2[:, C:], 0.0), axis=-1)
        else:
            row = cmf_rows[blk]                              # (N, C)
            r, prev_in = count_and_prev(row, row < s[..., None])
            idx = jnp.clip(blk * C + r, 0, d.size - 1)
            prev = jnp.where(r > 0, prev_in, prev_blk)
            pmf_i = d.pmf[idx]
    else:
        # first index i with cmf[i] >= s
        idx = jnp.clip(jnp.searchsorted(d.cmf, s, side="left"), 0, d.size - 1)
        idx = idx.astype(jnp.int32)
        prev = jnp.where(idx > 0, d.cmf[jnp.maximum(idx - 1, 0)], 0.0)
        pmf_i = d.pmf[idx]
    residual = s - prev
    remapped = jnp.clip(jnp.where(pmf_i > 0.0, residual / pmf_i, residual), 0.0, 1.0)
    return idx, pmf_i / d.total, remapped


def discrete_pdf(d: Discrete, idx: jax.Array) -> jax.Array:
    return d.pmf[idx] / d.total


class AliasTable(NamedTuple):
    """O(1) alias-method sampler for big tables (Walker/Vose semantics).

    One (N, 4) f32 row per cell: [q, pmf_self, pmf_alias, alias_index
    bitcast to f32] — sampling is ONE narrow row gather + selects,
    replacing the blocked cmf binary search (1-2 wide row gathers).

    ``pmf`` is the EFFECTIVE per-cell probability mass the table actually
    samples — recomputed from (q, alias) after construction — so the
    estimator is unbiased by construction even if build rounding shifts
    an assignment: pdf always describes exactly what sampling does.
    Parity: replaces cube_distrb.cpp:41-62's cmf search for the envmap
    grid; same sample_reuse contract (pmf.cpp:29-50).
    """
    packed: jax.Array    # (N, 4) f32
    pmf: jax.Array       # (N,) effective pmf (input-mass scale)
    total: jax.Array     # scalar

    @property
    def size(self) -> int:
        return self.pmf.shape[0]


def alias_table_host(mass) -> AliasTable:
    """Host-side (numpy, f64) alias-table construction, O(N log N).

    Vectorized prefix-sum formulation of Vose's two-pointer build, exact
    in the following sense (derivation in docs/performance.md):
    lights (w<1) and heavies (w>=1) are each kept in index order; with
    D_i = prefix deficits over lights and E_j = prefix excesses over
    heavies, light i's alias is heavy j where #{E < D_{i-1}} = j-1, and
    heavy j flips with prob 1 - (G_j - E_j) where G_j = first D > E_j,
    aliased to heavy j+1. The effective pmf is then recomputed from the
    built (q, alias) table so f32 rounding can never bias sampling.
    """
    import numpy as np
    mass = np.asarray(mass, np.float64).reshape(-1)
    n = mass.size
    total = mass.sum()
    if not np.isfinite(total) or total <= 0.0:
        mass = np.ones(n, np.float64)
        total = float(n)
    w = mass * (n / total)
    q = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int64)
    li = np.nonzero(w < 1.0)[0]
    hi = np.nonzero(w >= 1.0)[0]
    if li.size and hi.size:
        d = 1.0 - w[li]
        D = np.cumsum(d)
        E = np.cumsum(w[hi] - 1.0)
        # lights: alias = the heavy active when this light is processed
        k = np.searchsorted(E, D - d, side="left")
        alias[li] = hi[np.minimum(k, hi.size - 1)]
        q[li] = w[li]
        # heavies: flip iff some light deficit crosses their excess prefix
        m = np.searchsorted(D, E, side="right")
        flips = m < li.size
        G = D[np.minimum(m, li.size - 1)]
        q[hi] = np.where(flips, np.clip(1.0 - (G - E), 0.0, 1.0), 1.0)
        nxt = hi[np.minimum(np.arange(hi.size) + 1, hi.size - 1)]
        alias[hi] = np.where(flips, nxt, hi)
    # effective pmf: q_i + sum over cells aliased here of (1 - q)
    eff = q.copy()
    np.add.at(eff, alias, 1.0 - q)
    pmf_eff = (eff * (total / n)).astype(np.float32)
    packed = np.empty((n, 4), np.float32)
    packed[:, 0] = q
    packed[:, 1] = pmf_eff
    packed[:, 2] = pmf_eff[alias]
    packed[:, 3] = alias.astype(np.int32).view(np.float32)
    return AliasTable(packed=packed, pmf=pmf_eff,
                      total=np.float32(pmf_eff.sum()))


def alias_sample_reuse(at: AliasTable, samples: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Same contract as ``discrete_sample_reuse``: (idx, pdf_normalized,
    samples_remapped) — one uniform consumed, remainder recycled uniform.

    Cell selection is EXACT fixed-point int32 arithmetic, not
    ``floor(u * n)``: for n in the millions (reference-parity envmap
    grids reach 8M cells) the f32 product quantizes to ~n/2^24-cell
    steps, which measurably biased the sampled cell distribution (1.2%
    scene-mean shift on bunny_env_2 at div=1). With k = floor(u * 2^24)
    (exact: power-of-two scale) the cell is floor(k*n / 2^24), computed
    overflow-free by 12-bit splits of both factors."""
    n = at.size
    assert n < (1 << 24), "alias tables support up to 2^24 cells"
    u = jnp.clip(samples, 0.0, 1.0 - 1e-7)
    ks = u * jnp.float32(1 << 24)
    k = ks.astype(jnp.int32)                       # exact: 2^24 scale
    u_res = ks - k.astype(ks.dtype)                # sub-quantum residual
    k_hi, k_lo = k >> 12, k & 0xFFF
    n_hi, n_lo = n >> 12, n & 0xFFF
    L = k_lo * n_lo                                # < 2^24
    M = k_hi * n_lo + k_lo * n_hi + (L >> 12)      # < 2^26
    c = jnp.clip(k_hi * n_hi + (M >> 12), 0, n - 1)
    mod24 = ((M & 0xFFF) << 12) | (L & 0xFFF)      # (k*n) mod 2^24
    frac = (mod24.astype(jnp.float32) + u_res) * jnp.float32(1.0 / (1 << 24))
    row = at.packed[c]                             # ONE (N, 4) row gather
    q = row[..., 0]
    al = jax.lax.bitcast_convert_type(row[..., 3], jnp.int32)
    take_self = frac < q
    idx = jnp.where(take_self, c, al)
    pmf_i = jnp.where(take_self, row[..., 1], row[..., 2])
    denom = jnp.where(take_self, q, 1.0 - q)
    num = jnp.where(take_self, frac, frac - q)
    remapped = jnp.clip(num / jnp.maximum(denom, 1e-12), 0.0, 1.0)
    return idx, pmf_i / at.total, remapped


class Hier2D(NamedTuple):
    """Hierarchical 2D sample warp over a regular (gw, gh) grid.

    Monotone-per-axis alternative to both the flattened 1D cmf search
    (1-2 wide (N, 256) row gathers + broadcast compare rows) and the
    alias table (O(1) but a non-monotone u->cell map that destroys
    (0,2)-sequence stratification — measured 1.73x NEE variance on the
    envmap scenes). The grid is padded to per-axis powers of two
    and factored into ceil(log8) descent steps of up to 8x8 children;
    each step stores, per node, its children's subtree masses as one
    (ax, ay) row, so descending a step is ONE narrow (N, <=64) row
    gather + tiny VPU inverse-CDFs (first the x-marginal with u0, then
    the conditional row with u1). Both per-axis maps are nested inverse
    CDFs, hence monotone in u0 / u1 — stratified and low-discrepancy
    point sets keep their 2D structure through the warp, unlike the
    flattened cmf (which stratifies only the row-major order) and the
    alias map (not monotone at all).

    Zero-mass (padded) cells are never selected: a child with zero mass
    has a zero-width inverse-CDF interval and the strict `cmf < s`
    count always lands on a neighbor with mass. The finest-level row
    entries are f32 casts of the same f64 subtree sums as ``pmf``, so
    the pdf the sampler reports (last chosen child mass / total) is
    bit-identical to ``pmf[cell] / total`` — pdf always describes
    exactly what sampling does (the AliasTable discipline).

    Parity: replaces cube_distrb.cpp:41-62's cmf search for the envmap
    grid; same contract as ``discrete_sample_reuse`` (pmf.cpp:29-50)
    with the residual uniforms recycled as the in-cell coordinates.
    """
    levels: tuple          # per step: (n_nodes, ax, ay) f32 child masses
    pmf: jax.Array         # (gw*gh,) f32, real grid, x-major (y fastest)
    total: jax.Array       # scalar f32 (f64 host sum, cast once)

    @property
    def size(self) -> int:
        return self.pmf.shape[0]


def _hier_split_plan(pw: int, ph: int):
    """Factor (pw, ph) powers of two into aligned per-step (ax, ay)
    splits of at most 8 each (coarse -> fine); the shorter axis pads
    with 1s at the coarse end."""
    def plan(p):
        out = []
        while p > 1:
            f = min(8, p)
            out.append(f)
            p //= f
        return out
    px, py = plan(pw), plan(ph)
    steps = max(len(px), len(py), 1)
    px = [1] * (steps - len(px)) + px
    py = [1] * (steps - len(py)) + py
    return list(zip(px, py))


def hier2d_host(mass, gw: int, gh: int) -> Hier2D:
    """Host-side (numpy, f64) hierarchical-warp table build, O(N)."""
    import numpy as np
    m = np.asarray(mass, np.float64).reshape(gw, gh)
    total = m.sum()
    if not np.isfinite(total) or total <= 0.0:
        m = np.ones((gw, gh), np.float64)
        total = float(gw * gh)
    pw = 1 << max(0, int(gw - 1).bit_length())
    ph = 1 << max(0, int(gh - 1).bit_length())
    assert max(pw, ph) <= 4096, \
        "hier2d supports up to 4096 cells per axis (f32 cell+frac sums)"
    M = np.zeros((pw, ph), np.float64)
    M[:gw, :gh] = m
    steps = _hier_split_plan(pw, ph)
    tabs = []
    S = M
    for ax, ay in reversed(steps):
        nx, ny = S.shape
        nnx, nny = nx // ax, ny // ay
        t = S.reshape(nnx, ax, nny, ay).transpose(0, 2, 1, 3)
        tabs.append(t.reshape(nnx * nny, ax, ay).astype(np.float32))
        S = t.sum(axis=(2, 3))
    return Hier2D(levels=tuple(tabs[::-1]),
                  pmf=M[:gw, :gh].reshape(-1).astype(np.float32),
                  total=np.float32(total))


def _invcdf_small(m: jax.Array, u: jax.Array):
    """Inverse CDF over a tiny (..., K) mass row: (bin, remapped u,
    bin mass). Strict `cmf < s` count skips zero-width bins; selects
    are index-based compare chains (~free on VPU, round-2 gather
    facts)."""
    K = m.shape[-1]
    if K == 1:
        return (jnp.zeros(u.shape, jnp.int32), u, m[..., 0])
    c = jnp.cumsum(m, axis=-1)
    s = u * c[..., -1]
    k = jnp.clip(jnp.sum(c < s[..., None], axis=-1, dtype=jnp.int32),
                 0, K - 1)
    iota = jnp.arange(K, dtype=jnp.int32)
    mk = jnp.sum(jnp.where(iota == k[..., None], m, 0.0), axis=-1)
    prev = jnp.sum(jnp.where(iota == (k - 1)[..., None], c, 0.0), axis=-1)
    res = s - prev
    u2 = jnp.clip(jnp.where(mk > 0.0, res / mk, res), 0.0, 1.0 - 1e-7)
    return k, u2, mk


def hier2d_sample_reuse(h: Hier2D, samples: jax.Array, resolution):
    """samples (..., 2) in [0,1)^2 -> (warped (..., 2) in real-grid uv,
    normalized cell pdf). One narrow row gather + two tiny inverse CDFs
    per level; u0 warps the x axis, u1 the y axis."""
    u0 = jnp.clip(samples[..., 0], 0.0, 1.0 - 1e-7)
    u1 = jnp.clip(samples[..., 1], 0.0, 1.0 - 1e-7)
    ix = jnp.zeros(u0.shape, jnp.int32)
    iy = jnp.zeros(u0.shape, jnp.int32)
    ny_nodes = 1
    mk = h.total
    for tab in h.levels:
        n_nodes, ax, ay = tab.shape
        # root level has one node: no gather (and XLA folds its tiny CDFs)
        row = tab[0] if n_nodes == 1 else tab[ix * ny_nodes + iy]
        i, u0, _ = _invcdf_small(jnp.sum(row, axis=-1), u0)
        iota = jnp.arange(ax, dtype=jnp.int32)
        cond = jnp.sum(jnp.where((iota == i[..., None])[..., None],
                                 row, 0.0), axis=-2)     # (..., ay)
        j, u1, mk = _invcdf_small(cond, u1)
        ix = ix * ax + i
        iy = iy * ay + j
        ny_nodes = ny_nodes * ay
    reso = jnp.asarray(resolution, jnp.float32)
    # cap the in-cell fractions at 1 - 2^-10 so `cell + frac` can never
    # round up across the cell boundary in f32 (f32 ulp at 4096 is
    # 2^-11; hier2d_host asserts reso <= 4096) — keeps the reported pdf
    # consistent with floor(warped * reso) on every lane
    cap = jnp.float32(1.0 - 1.0 / 1024.0)
    warped = jnp.stack(
        [(ix.astype(jnp.float32) + jnp.minimum(u0, cap)) / reso[0],
         (iy.astype(jnp.float32) + jnp.minimum(u1, cap)) / reso[1]],
        axis=-1)
    # mk is the finest-level chosen child mass — bit-identical to
    # pmf[ix*gh + iy] by construction (same f64 value, same f32 cast)
    return warped, mk / h.total


class HyperCube(NamedTuple):
    """Piecewise-constant distribution over a regular n-D grid
    (cube_distrb.cpp:8-75). ``cells`` holds each flat cell's integer grid
    coordinates; ``unit`` = 1/resolution. When ``alias`` is present it
    replaces the cmf search (``distrb`` may then be None and ``cells``
    an empty placeholder — the big-grid frozen-envmap path).
    """
    distrb: Discrete | None
    cells: jax.Array       # (num_cells, ndim) int32 (may be (0, ndim))
    resolution: jax.Array  # (ndim,) int32
    unit: jax.Array        # (ndim,) float32
    alias: AliasTable | None = None
    hier: Hier2D | None = None

    @property
    def num_cells(self) -> int:
        if self.distrb is not None:
            return self.distrb.pmf.shape[0]
        if self.alias is not None:
            return self.alias.size
        return self.hier.size

    @property
    def ndim(self) -> int:
        return self.resolution.shape[0]


def hypercube_cells(resolution) -> jax.Array:
    """Flat-index -> grid-coordinate decomposition (cube_distrb.cpp:8-29).

    Row-major: last dim fastest.
    """
    reso = tuple(int(r) for r in resolution)
    grids = jnp.meshgrid(*[jnp.arange(r, dtype=jnp.int32) for r in reso], indexing="ij")
    return jnp.stack([g.reshape(-1) for g in grids], axis=-1)


def hypercube_init(resolution, mass: jax.Array | None = None) -> HyperCube:
    reso = jnp.asarray(resolution, jnp.int32)
    cells = hypercube_cells(resolution)
    n = cells.shape[0]
    if mass is None:
        mass = jnp.ones((n,), jnp.float32)
    assert mass.shape[0] == n
    return HyperCube(
        distrb=discrete_init(mass),
        cells=cells,
        resolution=reso,
        unit=1.0 / reso.astype(jnp.float32),
    )


def hypercube_set_mass(hc: HyperCube, mass: jax.Array) -> HyperCube:
    # an all-zero mass table (e.g. guiding preprocess found no valid
    # boundary segments) must degrade to uniform sampling, not to a
    # zero-pdf distribution that silently kills every guided sample
    total = jnp.sum(mass)
    mass = jnp.where(total > 0.0, mass, jnp.ones_like(mass))
    return hc._replace(distrb=discrete_init(mass))


def hypercube_sample_reuse(hc: HyperCube, samples: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """samples (..., ndim) in [0,1)^ndim -> (warped samples, pdf).

    Picks a cell using the *last* component, then maps the remainder
    uniformly inside the cell (cube_distrb.cpp:41-50).
    """
    if hc.hier is not None:
        warped, pdf_norm = hier2d_sample_reuse(hc.hier, samples,
                                               hc.resolution)
        return warped, pdf_norm * hc.num_cells
    if hc.alias is not None:
        idx, pdf, last = alias_sample_reuse(hc.alias, samples[..., -1])
    else:
        idx, pdf, last = discrete_sample_reuse(hc.distrb, samples[..., -1])
    samples = jnp.concatenate([samples[..., :-1], last[..., None]], axis=-1)
    # arithmetic flat-index -> grid-coordinate decode (row-major, last dim
    # fastest — hypercube_cells layout) instead of a wavefront gather into
    # the (num_cells, ndim) table
    coords = []
    rem = idx
    for i in range(hc.ndim - 1, -1, -1):
        coords.append(rem % hc.resolution[i])
        rem = rem // hc.resolution[i]
    cell = jnp.stack(coords[::-1], axis=-1)
    warped = (samples + cell.astype(samples.dtype)) * hc.unit
    return warped, pdf * hc.num_cells


def hypercube_pdf(hc: HyperCube, p: jax.Array) -> jax.Array:
    """Density at points p (..., ndim) in [0,1)^ndim (cube_distrb.cpp:53-66)."""
    reso = hc.resolution
    ip = jnp.floor(p * reso.astype(p.dtype)).astype(jnp.int32)
    valid = jnp.all((ip >= 0) & (ip < reso), axis=-1)
    ndim = hc.ndim
    idx = ip[..., 0]
    for i in range(1, ndim):
        idx = idx * reso[i] + ip[..., i]
    idx = jnp.clip(idx, 0, hc.num_cells - 1)
    if hc.alias is not None:
        pdf_norm = hc.alias.pmf[idx] / hc.alias.total
    elif hc.hier is not None:
        pdf_norm = hc.hier.pmf[idx] / hc.hier.total
    else:
        pdf_norm = hc.distrb.pmf[idx] / hc.distrb.total
    return jnp.where(valid, pdf_norm * hc.num_cells, 0.0)
