"""Unit tests for the core math / sampling layer (SURVEY.md §4a:
pure-function tests against closed forms)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from psdr_tpu.core import frame, warp, math as m, transform as xf
from psdr_tpu.core.distribution import (discrete_init, discrete_sample_reuse,
                                        hypercube_init, hypercube_pdf,
                                        hypercube_sample_reuse)


def test_frame_orthonormal():
    key = jax.random.PRNGKey(0)
    n = m.normalize(jax.random.normal(key, (1000, 3)))
    f = frame.make_frame(n)
    assert np.allclose(m.dot(f.s, f.t), 0, atol=1e-5)
    assert np.allclose(m.dot(f.s, f.n), 0, atol=1e-5)
    assert np.allclose(m.norm(f.s), 1, atol=1e-5)
    assert np.allclose(m.norm(f.t), 1, atol=1e-5)
    # round trip
    v = m.normalize(jax.random.normal(jax.random.PRNGKey(1), (1000, 3)))
    v2 = frame.to_world(f, frame.to_local(f, v))
    assert np.allclose(v, v2, atol=1e-5)


def test_cosine_hemisphere_pdf_integrates_to_one():
    # Monte-Carlo check: E[pdf-weighted] consistency + chi-square-ish moment
    u = jax.random.uniform(jax.random.PRNGKey(2), (200000, 2))
    v = warp.square_to_cosine_hemisphere(u)
    assert np.all(np.asarray(v[:, 2]) >= 0)
    assert np.allclose(m.norm(v), 1, atol=1e-4)
    # cos-weighted sampling => E[z] = integral z * (z/pi) dOmega = 2/3
    assert abs(float(jnp.mean(v[:, 2])) - 2.0 / 3.0) < 5e-3


def test_uniform_triangle():
    u = jax.random.uniform(jax.random.PRNGKey(3), (100000, 2))
    b = warp.square_to_uniform_triangle(u)
    b = np.asarray(b)
    assert np.all(b >= 0) and np.all(b.sum(-1) <= 1 + 1e-6)
    # centroid of uniform samples on unit right triangle is (1/3, 1/3)
    assert np.allclose(b.mean(0), [1 / 3, 1 / 3], atol=5e-3)


def test_discrete_sample_reuse():
    pmf = jnp.array([1.0, 2.0, 3.0, 4.0])
    d = discrete_init(pmf)
    u = jax.random.uniform(jax.random.PRNGKey(4), (200000,))
    idx, pdf, rem = discrete_sample_reuse(d, u)
    idx = np.asarray(idx)
    counts = np.bincount(idx, minlength=4) / idx.shape[0]
    assert np.allclose(counts, [0.1, 0.2, 0.3, 0.4], atol=5e-3)
    assert np.allclose(np.asarray(pdf), np.asarray(pmf)[idx] / 10.0)
    rem = np.asarray(rem)
    assert np.all((rem >= 0) & (rem <= 1))
    # remapped residuals must be ~uniform (mean 1/2, var 1/12)
    assert abs(rem.mean() - 0.5) < 5e-3
    assert abs(rem.var() - 1 / 12) < 5e-3


def test_hypercube_distribution_3d():
    hc = hypercube_init((4, 3, 2))
    mass = jnp.arange(24, dtype=jnp.float32) + 1.0
    from psdr_tpu.core.distribution import hypercube_set_mass
    hc = hypercube_set_mass(hc, mass)
    u = jax.random.uniform(jax.random.PRNGKey(5), (100000, 3))
    w, pdf = hypercube_sample_reuse(hc, u)
    w_np = np.asarray(w)
    assert np.all((w_np >= 0) & (w_np <= 1))
    # pdf at the sampled point must equal the returned pdf
    pdf2 = hypercube_pdf(hc, w)
    assert np.allclose(np.asarray(pdf), np.asarray(pdf2), rtol=1e-5)
    # MC integral of 1/pdf over samples = volume = 1
    assert abs(float(jnp.mean(1.0 / pdf)) - 1.0) < 2e-2


def test_moeller_trumbore_and_grad():
    p0 = jnp.array([[0.0, 0.0, 1.0]])
    e1 = jnp.array([[1.0, 0.0, 0.0]])
    e2 = jnp.array([[0.0, 1.0, 0.0]])
    o = jnp.array([[0.2, 0.3, 0.0]])
    d = jnp.array([[0.0, 0.0, 1.0]])
    uv, t = m.ray_intersect_triangle(p0, e1, e2, o, d)
    assert np.allclose(np.asarray(t), 1.0, atol=1e-6)
    assert np.allclose(np.asarray(uv), [[0.2, 0.3]], atol=1e-6)

    # derivative of hit distance w.r.t. triangle z-offset is 1
    def f(z):
        uv2, t2 = m.ray_intersect_triangle(p0 + jnp.array([0, 0, 1.0]) * z,
                                           e1, e2, o, d)
        return t2[0]
    g = jax.grad(f)(0.0)
    assert np.allclose(np.asarray(g), 1.0, atol=1e-5)


def test_transforms():
    p = jnp.array([[1.0, 2.0, 3.0]])
    t = xf.translate([1.0, 0.0, 0.0])
    assert np.allclose(np.asarray(xf.transform_pos(t, p)), [[2, 2, 3]])
    r = xf.rotate([0, 0, 1], 90.0)
    out = xf.transform_pos(r, jnp.array([[1.0, 0.0, 0.0]]))
    assert np.allclose(np.asarray(out), [[0, 1, 0]], atol=1e-6)
    lk = xf.look_at([0, 0, 0], [0, 0, 5], [0, 1, 0])
    d = xf.transform_dir(lk, jnp.array([[0.0, 0.0, 1.0]]))
    assert np.allclose(np.asarray(d), [[0, 0, 1]], atol=1e-6)


def test_aabb_exit():
    lower = jnp.array([-1.0, -1.0, -1.0])
    upper = jnp.array([1.0, 1.0, 1.0])
    o = jnp.zeros((1, 3))
    d = jnp.array([[1.0, 0.0, 0.0]])
    t, n, G = m.ray_intersect_scene_aabb(o, d, lower, upper)
    assert np.allclose(np.asarray(t), 1.0)
    assert np.allclose(np.asarray(n), [[-1, 0, 0]])
    assert np.allclose(np.asarray(G), 1.0)


def test_fresnel_normal_incidence():
    # At normal incidence: R = ((n-1)^2 + k^2) / ((n+1)^2 + k^2)
    eta = jnp.array([[2.0, 2.0, 2.0]])
    k = jnp.array([[0.0, 0.0, 0.0]])
    F = m.fresnel_conductor(eta, k, jnp.array([1.0]))
    assert np.allclose(np.asarray(F), ((2 - 1) / (2 + 1)) ** 2, atol=1e-5)


def test_discrete_small_table_matches_searchsorted():
    """The broadcast small-table branch of discrete_sample_reuse must equal
    the searchsorted branch bit-exactly (same entries selected, same
    arithmetic on them)."""
    import psdr_tpu.core.distribution as dist
    key = jax.random.PRNGKey(3)
    pmf = jnp.concatenate([jax.random.uniform(key, (13,)),
                           jnp.zeros((3,))])  # include zero-mass entries
    pmf = pmf[jax.random.permutation(key, 16)]
    d = discrete_init(pmf)
    u = jax.random.uniform(jax.random.PRNGKey(4), (4096,))
    u = jnp.concatenate([u, jnp.array([0.0, 0.999999])])
    i1, p1, r1 = discrete_sample_reuse(d, u)

    # force the searchsorted branch by faking the size check (> 2^25 so
    # neither small-table nor blocked path is taken)
    import unittest.mock as mock
    with mock.patch.object(type(d), "size",
                           property(lambda self: 1 << 26)):
        i2, p2, r2 = discrete_sample_reuse(d, u)
    assert np.array_equal(np.asarray(i1), np.asarray(i2))
    assert np.array_equal(np.asarray(p1), np.asarray(p2))
    assert np.array_equal(np.asarray(r1), np.asarray(r2))


def test_brute_small_f_matches_tiled():
    """The statically unrolled small-F brute path must agree with the tiled
    path exactly (same MT arithmetic)."""
    from psdr_tpu.accel.bruteforce import (_brute_small_f,
                                           ray_intersect_brute)
    key = jax.random.PRNGKey(7)
    k1, k2, k3 = jax.random.split(key, 3)
    p0 = jax.random.normal(k1, (6, 3))
    e1 = jax.random.normal(k2, (6, 3))
    e2 = jax.random.normal(k3, (6, 3))
    o = jax.random.normal(jax.random.PRNGKey(8), (512, 3)) * 3.0
    dirs = jax.random.normal(jax.random.PRNGKey(9), (512, 3))
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    act = jnp.ones((512,), bool)
    tmax = jnp.full((512,), jnp.inf)
    a = _brute_small_f(p0, e1, e2, o, dirs, act, tmax)
    # force the tiled path by exceeding the small-F threshold with copies
    p0b = jnp.concatenate([p0] * 5)[:25]
    e1b = jnp.concatenate([e1] * 5)[:25]
    e2b = jnp.concatenate([e2] * 5)[:25]
    b = ray_intersect_brute(p0b, e1b, e2b, o, dirs, act)
    # hits on the duplicated set map back to the same primitives mod 6
    assert np.array_equal(np.asarray(a.valid), np.asarray(b.valid))
    assert np.allclose(np.asarray(a.t)[np.asarray(a.valid)],
                       np.asarray(b.t)[np.asarray(b.valid)], rtol=1e-6)


def test_select_rows_matches_gather():
    from psdr_tpu.scene.scene import select_rows
    key = jax.random.PRNGKey(11)
    table = jax.random.normal(key, (7, 3))
    idx = jax.random.randint(jax.random.PRNGKey(12), (300,), 0, 7)
    assert np.array_equal(np.asarray(select_rows(table, idx)),
                          np.asarray(table[idx]))
    table1 = jax.random.normal(key, (5,))
    assert np.array_equal(np.asarray(select_rows(table1, idx % 5)),
                          np.asarray(table1[idx % 5]))


def test_discrete_twolevel_matches_searchsorted():
    """The two-level broadcast branch (32 < size <= 2^18) must equal the
    searchsorted branch exactly."""
    import unittest.mock as mock
    for n in (33, 300, 8192, 130001, 300011):
        key = jax.random.PRNGKey(n)
        pmf = jax.random.uniform(key, (n,))
        # sprinkle zero-mass plateaus
        pmf = jnp.where(jax.random.uniform(jax.random.PRNGKey(n + 1),
                                           (n,)) < 0.2, 0.0, pmf)
        d = discrete_init(pmf)
        u = jax.random.uniform(jax.random.PRNGKey(n + 2), (20000,))
        u = jnp.concatenate([u, jnp.array([0.0, 0.9999999])])
        i1, p1, r1 = discrete_sample_reuse(d, u)
        with mock.patch.object(type(d), "size",
                               property(lambda self: 1 << 26)):
            i2, p2, r2 = discrete_sample_reuse(d, u)
        assert np.array_equal(np.asarray(i1), np.asarray(i2)), n
        assert np.array_equal(np.asarray(p1), np.asarray(p2)), n
        assert np.array_equal(np.asarray(r1), np.asarray(r2)), n


def test_gather_rows_vjp_modes_agree():
    """Every gather_rows backward mode must produce the same table
    gradient as XLA's native gather transpose (cumsum to float32
    prefix-sum tolerance), for 1-D and 2-D lane index shapes."""
    from psdr_tpu.core.gather import gather_rows

    F, C, N = 257, 32, 1 << 16
    key = jax.random.PRNGKey(7)
    table = jax.random.normal(key, (F, C))
    idx = jax.random.randint(jax.random.PRNGKey(8), (N,), 0, F, jnp.int32)
    w = jax.random.normal(jax.random.PRNGKey(9), (N, C))

    def loss(t, mode, shape=None):
        i = idx if shape is None else idx.reshape(shape)
        ww = w if shape is None else w.reshape(shape + (C,))
        return jnp.sum(gather_rows(t, i, mode=mode) * ww)

    ref = jax.grad(lambda t: loss(t, "native"))(table)
    for mode in ("scatter", "sorted", "cumsum"):
        g = jax.grad(lambda t: loss(t, mode))(table)
        tol = 2e-3 if mode == "cumsum" else 1e-6
        np.testing.assert_allclose(np.asarray(g), np.asarray(ref),
                                   rtol=tol, atol=tol * np.abs(ref).max(),
                                   err_msg=mode)
    # multi-dim lane shape (bitmap eval)
    g2 = jax.grad(lambda t: loss(t, "sorted", shape=(256, 256)))(table)
    np.testing.assert_allclose(np.asarray(g2), np.asarray(ref),
                               rtol=1e-6, atol=1e-5)


def test_gather_rows_vjp_modes_render_grads_agree():
    """End-to-end: interior render gradients must match across gather
    backward modes on a textured scene (face table + bitmap paths)."""
    import dataclasses
    from scenes import cbox_scene
    from psdr_tpu import DirectIntegrator
    from psdr_tpu.core.gather import set_gather_vjp_mode

    sc = cbox_scene(width=16, height=16, spp=4)
    integ = DirectIntegrator(1, 1)
    grads = {}
    jvps = {}
    try:
        for mode in ("native", "sorted", "cumsum"):
            set_gather_vjp_mode(mode)
            render = jax.jit(integ.render_fn(sc, with_boundary=False))

            def loss(params):
                return jnp.sum(render(params, jax.random.PRNGKey(3)))

            grads[mode] = jax.grad(loss)(sc.params())
            # forward mode too: the AD-vs-FD harness (run_ad) drives
            # jax.jvp through renders, so a flipped default must not
            # break it (linear_call supports both; custom_vjp wouldn't)
            p0 = sc.params()
            tang = jax.tree.map(jnp.ones_like, p0)
            jvps[mode] = float(jax.jvp(loss, (p0,), (tang,))[1])
    finally:
        set_gather_vjp_mode("native")
    for mode in ("sorted", "cumsum"):
        np.testing.assert_allclose(jvps[mode], jvps["native"], rtol=1e-4)
    ref = grads["native"]
    for mode in ("sorted", "cumsum"):
        jax.tree.map(
            lambda a, b: np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=2e-3,
                atol=2e-3 * (np.abs(np.asarray(a)).max() + 1e-8)),
            ref, grads[mode])


def test_gather_rows_jvp_and_offsets():
    """Forward-mode AD must work through every gather mode (the AD-vs-FD
    harness drives jax.jvp through renders), and the shared-sort offsets
    variant must match per-offset gathers in both primal and gradient."""
    from psdr_tpu.core.gather import gather_rows, gather_rows_offsets

    F, C, N = 130, 8, 4096
    table = jax.random.normal(jax.random.PRNGKey(0), (F, C))
    tang = jax.random.normal(jax.random.PRNGKey(1), (F, C))
    idx = jax.random.randint(jax.random.PRNGKey(2), (N,), 0, F - 3,
                             jnp.int32)
    w = jax.random.normal(jax.random.PRNGKey(3), (N, C))

    ref_p, ref_t = jax.jvp(lambda t: jnp.sum(gather_rows(t, idx) * w),
                           (table,), (tang,))
    for mode in ("scatter", "sorted", "cumsum"):
        p, t = jax.jvp(
            lambda tt: jnp.sum(gather_rows(tt, idx, mode=mode) * w),
            (table,), (tang,))
        np.testing.assert_allclose(np.asarray(p), np.asarray(ref_p),
                                   rtol=1e-6, err_msg=mode)
        np.testing.assert_allclose(np.asarray(t), np.asarray(ref_t),
                                   rtol=1e-6, err_msg=mode)

    offs = (0, 1, 2)

    def loss_offsets(t, mode):
        parts = gather_rows_offsets(t, idx, offs, mode=mode)
        return sum(jnp.sum(p * w) for p in parts)

    def loss_sep(t):
        return sum(jnp.sum(t[idx + o] * w) for o in offs)

    g_ref = jax.grad(loss_sep)(table)
    for mode in ("native", "scatter", "sorted", "cumsum"):
        v = loss_offsets(table, mode)
        np.testing.assert_allclose(np.asarray(v),
                                   np.asarray(loss_sep(table)), rtol=1e-6)
        g = jax.grad(lambda t: loss_offsets(t, mode))(table)
        tol = 2e-3 if mode == "cumsum" else 1e-5
        np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                                   rtol=tol, atol=tol, err_msg=mode)


def test_gather_rows_cumsum_backward_is_scatter_free():
    """The cumsum mode's entire point: its backward HLO must contain NO
    scatter op (native/sorted lower the reduction to XLA scatter)."""
    from psdr_tpu.core.gather import gather_rows

    F, C, N = 257, 32, 4096
    table = jax.random.normal(jax.random.PRNGKey(0), (F, C))
    idx = jax.random.randint(jax.random.PRNGKey(1), (N,), 0, F, jnp.int32)
    w = jax.random.normal(jax.random.PRNGKey(2), (N, C))

    def hlo(mode):
        g = jax.jit(jax.grad(
            lambda t: jnp.sum(gather_rows(t, idx, mode=mode) * w)))
        return g.lower(table).as_text()

    assert "scatter" in hlo("native")     # baseline really scatters
    assert "scatter" not in hlo("cumsum")


def test_ld_sequence_elementary_intervals():
    """The scrambled (0,2)-sequence must put exactly one point in every
    dyadic a x b cell for all a*b = spp splits (the property that makes
    sampler="sobol" strictly stronger than an a x b stratification)."""
    from psdr_tpu.core.sampler import ld_2d

    for spp in (4, 16, 64):
        i = jnp.arange(spp)
        for scr in ((0, 0), (0xDEADBEEF, 0x12345678)):
            pts = np.asarray(ld_2d(i, jnp.uint32(scr[0]), jnp.uint32(scr[1])))
            assert ((pts >= 0) & (pts < 1)).all()
            a = 1
            while a <= spp:
                b = spp // a
                cells = (np.floor(pts[:, 0] * a).astype(int) * b
                         + np.floor(pts[:, 1] * b).astype(int))
                assert len(set(cells.tolist())) == spp, (spp, scr, a)
                a *= 2


def test_tile_pos_to_pixel_matches_table():
    """The arithmetic tile-order inverse must equal tiled_pixel_order
    exactly (the interior renderer uses it to skip a wavefront-sized
    gather) and decline non-tiling films."""
    from psdr_tpu.integrator.base import tile_pos_to_pixel, tiled_pixel_order

    for w, h in ((64, 32), (32, 96), (128, 128)):
        pos = jnp.arange(w * h, dtype=jnp.int32)
        arith = tile_pos_to_pixel(pos, w, h)
        assert arith is not None
        assert np.array_equal(np.asarray(arith), tiled_pixel_order(w, h))
    assert tile_pos_to_pixel(jnp.arange(4), 48, 48) is None


def test_alias_table_effective_pmf_matches_input():
    """Host alias construction: the recomputed effective pmf must equal the
    input pmf to f64 rounding (validity of the prefix-sum Vose build),
    including spiky masses, zeros, and near-uniform ties."""
    from psdr_tpu.core.distribution import alias_table_host
    rng = np.random.default_rng(3)
    for pmf in [
        rng.random(257).astype(np.float64),
        np.concatenate([np.zeros(100), [1e6], rng.random(57), np.zeros(30)]),
        np.ones(512),
        np.concatenate([np.full(5, 1e-12), [1.0]]),
    ]:
        at = alias_table_host(pmf)
        total = pmf.sum() if pmf.sum() > 0 else len(pmf)
        ref = (pmf if pmf.sum() > 0 else np.ones_like(pmf)) / total
        got = np.asarray(at.pmf, np.float64) / np.asarray(at.total, np.float64)
        assert np.abs(got - ref).max() < 1e-6, np.abs(got - ref).max()
        q = np.asarray(at.packed[:, 0])
        assert (q >= 0).all() and (q <= 1).all()
        al = np.asarray(at.packed[:, 3]).view(np.int32)
        assert (al >= 0).all() and (al < len(pmf)).all()


def test_alias_sample_reuse_exact_frequencies_and_uniform_remap():
    """A dense deterministic u-sweep must hit each cell with frequency equal
    to the table's effective pmf (exactly, up to grid quantization), and the
    remapped residual must stay uniform — the sample_reuse contract."""
    from psdr_tpu.core.distribution import (alias_table_host,
                                            alias_sample_reuse)
    import jax.numpy as jnp
    pmf = np.array([0.05, 0.3, 0.0, 0.15, 0.4, 0.1], np.float64)
    at_np = alias_table_host(pmf)
    at = jax.tree.map(jnp.asarray, at_np)
    M = 1 << 20
    u = (np.arange(M) + 0.5) / M
    idx, pdf, rem = jax.jit(alias_sample_reuse)(at, jnp.asarray(u, jnp.float32))
    idx, pdf, rem = map(np.asarray, (idx, pdf, rem))
    freq = np.bincount(idx, minlength=6) / M
    eff = np.asarray(at_np.pmf, np.float64) / np.asarray(at_np.total)
    assert np.abs(freq - eff).max() < 2e-5, np.abs(freq - eff).max()
    # pdf returned must equal the effective pmf of the chosen cell
    assert np.abs(pdf - eff[idx]).max() < 1e-6
    # remapped residual: uniform on [0,1) per chosen cell
    for i in range(6):
        r = rem[idx == i]
        if r.size > 1000:
            assert abs(r.mean() - 0.5) < 5e-3
            assert abs(np.mean(r < 0.25) - 0.25) < 5e-3
    assert (rem >= 0).all() and (rem <= 1).all()


def test_hier2d_warp_distribution_pdf_and_monotonicity():
    """Hierarchical 2D warp (distribution.py hier2d_*): empirical cell
    frequencies match the pmf, the reported pdf is the pmf the warped
    point lands in (up to f32 cell-boundary rounding, the same property
    the cmf path's ``(cell+u)*unit`` has), zero-mass (incl. padded)
    cells are never selected, and the map is monotone per sample axis —
    the stratification-preserving property that motivates it."""
    from psdr_tpu.core.distribution import (hier2d_host, hier2d_sample_reuse,
                                            _hier_split_plan)
    import jax.numpy as jnp

    assert _hier_split_plan(512, 256) == [(8, 8), (8, 8), (8, 4)]
    assert _hier_split_plan(2048, 1024) == [(8, 8), (8, 8), (8, 8), (4, 2)]
    assert _hier_split_plan(1, 1) == [(1, 1)]

    rng = np.random.default_rng(0)
    gw, gh = 12, 10                      # non-pow2: exercises zero padding
    mass = rng.random((gw, gh)) ** 3
    mass[3, 4] = 0.0
    h_np = hier2d_host(mass.reshape(-1), gw, gh)
    # subtree-sum consistency: each level's rows sum to its parent entries
    assert np.isclose(np.asarray(h_np.levels[0]).sum(),
                      np.asarray(h_np.total), rtol=1e-5)
    h = jax.tree.map(jnp.asarray, h_np)
    reso = jnp.asarray([gw, gh], jnp.int32)

    N = 200000
    u = jnp.asarray(rng.random((N, 2)).astype(np.float32))
    warped, pdf = jax.jit(lambda s: hier2d_sample_reuse(h, s, reso))(u)
    warped, pdf = np.asarray(warped), np.asarray(pdf)
    assert warped.min() >= 0.0 and warped.max() < 1.0
    xg, yg = warped[:, 0] * gw, warped[:, 1] * gh
    ix, iy = np.floor(xg).astype(int), np.floor(yg).astype(int)
    flat = ix * gh + iy
    pm = np.asarray(h_np.pmf, np.float64)
    # 1-ulp rtol: XLA lowers /total to mul-by-reciprocal
    match = np.isclose(pdf, pm[flat] / np.float64(h_np.total), rtol=1e-6)
    assert match.mean() > 0.999
    # every mismatch sits at an f32 cell boundary (rounding, not logic)
    bdry = np.minimum(np.abs(xg - np.round(xg)), np.abs(yg - np.round(yg)))
    assert np.all(bdry[~match] < 1e-3)
    assert not np.any(flat[match] == 3 * gh + 4)   # zero cell unsampled
    cnt = np.bincount(flat, minlength=gw * gh) / N
    ref = pm / pm.sum()
    assert np.abs(cnt - ref).max() < 5 * np.sqrt(ref.max() / N)
    # in-cell residuals stay uniform (sample_reuse contract)
    fx = xg - ix
    assert abs(fx.mean() - 0.5) < 0.01 and abs(np.mean(fx < 0.25) - 0.25) < 0.01

    # uniform mass on a pow2 grid: the warp is the identity (up to the
    # 2^-10 in-cell cap) and the pdf is exactly uniform
    h2 = jax.tree.map(jnp.asarray, hier2d_host(np.ones(64 * 32), 64, 32))
    w2, p2 = hier2d_sample_reuse(h2, u, jnp.asarray([64, 32], jnp.int32))
    assert float(jnp.abs(w2 - u).max()) < 1.0 / (32 * 1024) + 1e-5
    assert np.allclose(np.asarray(p2), 1.0 / (64 * 32), rtol=1e-5)

    # per-axis monotonicity
    u0s = np.sort(rng.random(3000)).astype(np.float32)
    w3, _ = hier2d_sample_reuse(
        h, jnp.stack([jnp.asarray(u0s),
                      jnp.full((3000,), 0.377, jnp.float32)], -1), reso)
    assert np.all(np.diff(np.asarray(w3[:, 0])) >= -1e-6)
    w4, _ = hier2d_sample_reuse(
        h, jnp.stack([jnp.full((3000,), 0.61, jnp.float32),
                      jnp.asarray(np.sort(rng.random(3000)).astype(np.float32))],
                     -1), reso)
    assert np.all(np.diff(np.asarray(w4[:, 1])) >= -1e-6)


@pytest.mark.parametrize("fn_name", ["transform_pos", "transform_dir"])
def test_transform_matmuls_are_full_precision(fn_name):
    """Geometry transforms must not run in TF32 on a GPU: every dot_general
    in their jaxpr carries Precision.HIGHEST, and the results agree with
    float64 numpy to float32 rounding."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from psdr_tpu.core import transform as xf

    fn = getattr(xf, fn_name)
    rng = np.random.default_rng(5)
    mat = np.asarray(xf.translate([0.3, -1.2, 2.0])
                     @ xf.rotate([0.2, 1.0, -0.4], 37.0)
                     @ xf.scale([1.5, 0.7, 2.2]), np.float32)
    pts = rng.uniform(-3, 3, (64, 3)).astype(np.float32)
    jaxpr = jax.make_jaxpr(fn)(jnp.asarray(mat), jnp.asarray(pts))
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert dots
    for e in dots:
        prec = e.params["precision"]
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec), prec
    got = np.asarray(fn(jnp.asarray(mat), jnp.asarray(pts)), np.float64)
    m64, p64 = mat.astype(np.float64), pts.astype(np.float64)
    if fn_name == "transform_pos":
        ref = p64 @ m64[:3, :3].T + m64[:3, 3]
        ref = ref / (p64 @ m64[3, :3] + m64[3, 3])[:, None]
    else:
        ref = p64 @ m64[:3, :3].T
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("kind", ["mesh_transform", "mesh_rotate",
                                  "envmap_rotate"])
def test_perturbation_matmuls_are_full_precision(kind):
    """The AD-vs-FD perturbations compose a traced transform with
    ``to_world``; that product must not run in TF32 on a GPU either: every
    dot_general carries Precision.HIGHEST, and the result agrees with the
    float64 product."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from psdr_tpu.core import transform as xf
    from psdr_tpu.testing.differential import PERTURBATIONS

    to_world = np.asarray(xf.translate([0.3, -1.2, 2.0])
                          @ xf.rotate([0.2, 1.0, -0.4], 37.0), np.float32)
    params = {"meshes": [{"to_world": jnp.asarray(to_world)}],
              "emitters": [{"to_world": jnp.asarray(to_world)}]}
    group = "emitters" if kind == "envmap_rotate" else "meshes"

    def moved(P):
        return PERTURBATIONS[kind](params, P)[group][0]["to_world"]

    jaxpr = jax.make_jaxpr(moved)(jnp.float32(0.7))
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert dots
    for e in dots:
        prec = e.params["precision"]
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec), prec
    step = (xf.translate(np.array([0.7, 0.0, 0.0])) if kind == "mesh_transform"
            else xf.rotate(np.array([0.0, 1.0, 0.0]), 0.7))
    ref = np.asarray(step, np.float64) @ to_world.astype(np.float64)
    np.testing.assert_allclose(np.asarray(moved(jnp.float32(0.7))), ref,
                               rtol=1e-6, atol=1e-6)
