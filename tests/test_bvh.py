"""BVH correctness: the implicit Morton-chunk BVH must return exactly the
same closest hits as brute force, on random soups and on real scenes."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from psdr_tpu.accel.bruteforce import ray_intersect_brute
from psdr_tpu.accel.bvh import (build_bvh_topology, ray_intersect_bvh,
                                refit_bvh)

from scenes import cbox_scene


def _random_soup(n_tris, seed=0):
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    e1 = rng.uniform(-0.3, 0.3, (n_tris, 3)).astype(np.float32)
    e2 = rng.uniform(-0.3, 0.3, (n_tris, 3)).astype(np.float32)
    return p0, e1, e2


def _random_rays(n_rays, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize("n_tris,leaf_size", [(7, 4), (64, 4), (501, 8),
                                              (2048, 4)])
def test_bvh_matches_brute(n_tris, leaf_size):
    p0, e1, e2 = _random_soup(n_tris)
    o, d = _random_rays(512)
    topo = build_bvh_topology(p0, e1, e2, leaf_size=leaf_size)
    bvh = refit_bvh(topo, jnp.asarray(p0), jnp.asarray(e1), jnp.asarray(e2))

    hb = ray_intersect_brute(jnp.asarray(p0), jnp.asarray(e1),
                             jnp.asarray(e2), o, d)
    hv = ray_intersect_bvh(bvh, o, d)

    np.testing.assert_array_equal(np.asarray(hb.valid), np.asarray(hv.valid))
    # same triangle except exact distance ties
    same = np.asarray(hb.tri_id) == np.asarray(hv.tri_id)
    tie = np.isclose(np.asarray(hb.t), np.asarray(hv.t), rtol=1e-5)
    assert np.all(same | tie)
    np.testing.assert_allclose(np.asarray(hb.t)[np.asarray(hb.valid)],
                               np.asarray(hv.t)[np.asarray(hv.valid)],
                               rtol=1e-5)


def test_bvh_respects_active_and_tmax():
    p0, e1, e2 = _random_soup(256)
    o, d = _random_rays(128)
    topo = build_bvh_topology(p0, e1, e2)
    bvh = refit_bvh(topo, jnp.asarray(p0), jnp.asarray(e1), jnp.asarray(e2))

    active = jnp.arange(128) % 2 == 0
    hv = ray_intersect_bvh(bvh, o, d, active=active)
    assert not np.any(np.asarray(hv.valid)[1::2])

    hb = ray_intersect_brute(jnp.asarray(p0), jnp.asarray(e1),
                             jnp.asarray(e2), o, d)
    tmax = jnp.where(hb.valid, hb.t * 0.5, jnp.inf)
    hv2 = ray_intersect_bvh(bvh, o, d, tmax=tmax)
    # with tmax below the closest hit, those rays must miss or hit closer
    closer = np.asarray(hv2.t) <= np.asarray(tmax) + 1e-6
    assert np.all(closer | ~np.asarray(hv2.valid))


def test_scene_render_same_with_bvh():
    """End-to-end: forcing the BVH backend must not change the image."""
    from psdr_tpu import DirectIntegrator

    sc1 = cbox_scene(width=24, height=24, spp=4)
    sc1.accel_mode = "brute"
    sc2 = cbox_scene(width=24, height=24, spp=4)
    sc2.accel_mode = "bvh_walk"

    integ = DirectIntegrator(1, 1)
    img1 = np.asarray(integ.renderC(sc1, seed=5))
    img2 = np.asarray(integ.renderC(sc2, seed=5))
    np.testing.assert_allclose(img1, img2, rtol=1e-4, atol=1e-5)


@pytest.mark.slow
def test_bvh_gradients_flow_through_recompute():
    """jax.grad through a BVH-backed render must match the brute-force
    gradients (traversal is detached; gradients use the recompute)."""
    from psdr_tpu import DirectIntegrator

    grads = []
    for mode in ("brute", "bvh_walk"):
        sc = cbox_scene(width=16, height=16, spp=2)
        sc.accel_mode = mode
        integ = DirectIntegrator(1, 1)
        f = integ.render_fn(sc, with_boundary=False)

        def loss(params):
            return jnp.mean(f(params, jax.random.PRNGKey(0)))

        g = jax.grad(loss)(sc.params())
        grads.append(np.asarray(g["bsdfs"][0]["reflectance"]))
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("n_tris,tri_block", [(64, 64), (501, 128),
                                              (2048, 512)])
def test_culled_matches_brute(n_tris, tri_block):
    from psdr_tpu.accel.bvh import ray_intersect_culled
    p0, e1, e2 = _random_soup(n_tris, seed=3)
    o, d = _random_rays(512, seed=4)
    topo = build_bvh_topology(p0, e1, e2, leaf_size=4)
    bvh = refit_bvh(topo, jnp.asarray(p0), jnp.asarray(e1), jnp.asarray(e2))

    hb = ray_intersect_brute(jnp.asarray(p0), jnp.asarray(e1),
                             jnp.asarray(e2), o, d)
    hv = ray_intersect_culled(bvh, o, d, tri_block=tri_block)

    np.testing.assert_array_equal(np.asarray(hb.valid), np.asarray(hv.valid))
    same = np.asarray(hb.tri_id) == np.asarray(hv.tri_id)
    tie = np.isclose(np.asarray(hb.t), np.asarray(hv.t), rtol=1e-5)
    assert np.all(same | tie)


def test_culled_respects_active():
    from psdr_tpu.accel.bvh import ray_intersect_culled
    p0, e1, e2 = _random_soup(256)
    o, d = _random_rays(128)
    topo = build_bvh_topology(p0, e1, e2)
    bvh = refit_bvh(topo, jnp.asarray(p0), jnp.asarray(e1), jnp.asarray(e2))
    active = jnp.arange(128) % 2 == 0
    hv = ray_intersect_culled(bvh, o, d, active=active)
    assert not np.any(np.asarray(hv.valid)[1::2])


def test_scene_render_same_with_culled():
    from psdr_tpu import DirectIntegrator

    sc1 = cbox_scene(width=24, height=24, spp=4)
    sc1.accel_mode = "brute"
    sc2 = cbox_scene(width=24, height=24, spp=4)
    sc2.accel_mode = "culled"

    integ = DirectIntegrator(1, 1)
    img1 = np.asarray(integ.renderC(sc1, seed=5))
    img2 = np.asarray(integ.renderC(sc2, seed=5))
    np.testing.assert_allclose(img1, img2, rtol=1e-4, atol=1e-5)


def _soup_bvh(n_tris, seed, leaf_size=4):
    p0, e1, e2 = _random_soup(n_tris, seed=seed)
    topo = build_bvh_topology(p0, e1, e2, leaf_size=leaf_size)
    bvh = refit_bvh(topo, jnp.asarray(p0), jnp.asarray(e1), jnp.asarray(e2))
    return (jnp.asarray(p0), jnp.asarray(e1), jnp.asarray(e2)), bvh


def _assert_same_hits(hb, hp, lanes=None):
    """Equal valid masks; equal triangle ids except exact distance ties."""
    np.testing.assert_array_equal(np.asarray(hb.valid), np.asarray(hp.valid))
    same = np.asarray(hb.tri_id) == np.asarray(hp.tri_id)
    tie = np.isclose(np.asarray(hb.t), np.asarray(hp.t), rtol=1e-5)
    ok = same | tie
    if lanes is not None:
        ok = ok | ~lanes
    assert np.all(ok)


def test_pallas_culled2_matches_brute_interpret():
    """The Triton-route kernel (interpret mode) must reproduce brute force,
    including tmax bounds and inactive lanes, for every block shape; the
    any-hit mode must agree on the hit/no-hit decision."""
    from psdr_tpu.accel.pallas_kernel import ray_intersect_pallas

    tris, bvh = _soup_bvh(2048, seed=9)
    o, d = _random_rays(600, seed=10)
    rng = np.random.default_rng(11)
    act = jnp.asarray(rng.uniform(size=600) > 0.1)
    tmax = jnp.asarray(np.where(rng.uniform(size=600) > 0.5, np.inf,
                                rng.uniform(0.5, 6, 600)), jnp.float32)
    hb = ray_intersect_brute(*tris, o, d, act, tmax=tmax)
    hp = ray_intersect_pallas(bvh, o, d, act, tmax=tmax)
    _assert_same_hits(hb, hp)
    np.testing.assert_allclose(np.asarray(hp.t)[np.asarray(hp.valid)],
                               np.asarray(hb.t)[np.asarray(hb.valid)],
                               rtol=1e-5)
    ha = ray_intersect_pallas(bvh, o, d, act, tmax=tmax, any_hit=True)
    np.testing.assert_array_equal(np.asarray(hb.valid), np.asarray(ha.valid))
    # block shapes change the schedule, never the result
    for ray_block, tri_block in ((16, 4), (32, 128), (128, 4096)):
        hs = ray_intersect_pallas(bvh, o, d, act, tmax=tmax,
                                  ray_block=ray_block, tri_block=tri_block)
        _assert_same_hits(hb, hs)
        hsa = ray_intersect_pallas(bvh, o, d, act, tmax=tmax, any_hit=True,
                                   ray_block=ray_block, tri_block=tri_block)
        np.testing.assert_array_equal(np.asarray(hb.valid),
                                      np.asarray(hsa.valid))


def test_refit_quality_trigger_recovers_cull_efficiency():
    """Morton order is frozen at prepare_accel; shuffling the geometry far
    from its build-time layout inflates the refit leaf areas. The trigger
    must detect the degradation, rebuild, and restore quality ~1."""
    from scenes import cbox_scene
    sc = cbox_scene(width=16, height=16, spp=1, occluder_subdiv=3)
    sc.accel_mode = "culled"
    sc.prepare_accel()
    assert abs(sc.refit_quality() - 1.0) < 1e-3  # fresh build == itself

    # deform: tear the occluder apart — translate its x>0 half 10x the
    # scene extent away. Build-time Morton leaves near the tear now mix
    # both halves (giant boxes); a fresh build separates the clusters.
    params = sc.params()
    occ = max(range(len(sc.meshes)), key=lambda i: sc.meshes[i].num_faces)
    v = np.asarray(params["meshes"][occ]["vertex_positions"]).copy()
    shift = 10.0 * (np.abs(v).max() + 1.0)
    v[v[:, 0] > 0.0, 0] += shift
    params["meshes"][occ] = dict(params["meshes"][occ],
                                 vertex_positions=jnp.asarray(v))
    q_before = sc.refit_quality(params)
    assert q_before > 1.3, f"tear should degrade quality, got {q_before}"

    assert sc.maybe_rebuild_accel(params, threshold=1.3)
    q_after = sc.refit_quality(params)
    assert q_after < 1.1, f"rebuild should restore quality, got {q_after}"
    # untriggered when already good
    assert not sc.maybe_rebuild_accel(params, threshold=1.3)

def test_pallas_culled2_inactive_blocks_skipped():
    """Ray blocks with no active lane end their walk at the root; results
    for every lane — active, inactive, and in fully-dead blocks — must
    still match brute force (the emitter-first occlusion sweep's shape:
    ~1% active, sorted active-first)."""
    from psdr_tpu.accel.pallas_kernel import ray_intersect_pallas

    tris, bvh = _soup_bvh(1024, seed=21)
    o, d = _random_rays(1024, seed=22)
    for act_np in (np.arange(1024) < 20,           # blocks 1..7 fully dead
                   np.zeros(1024, bool),           # every block dead
                   (np.arange(1024) // 128) == 3):  # one interior block live
        act = jnp.asarray(act_np)
        hb = ray_intersect_brute(*tris, o, d, act)
        hp = ray_intersect_pallas(bvh, o, d, act, ray_block=128)
        _assert_same_hits(hb, hp, lanes=act_np)
        ha = ray_intersect_pallas(bvh, o, d, act, ray_block=128,
                                  any_hit=True)
        np.testing.assert_array_equal(np.asarray(hb.valid),
                                      np.asarray(ha.valid))


@pytest.mark.parametrize("n_rays", [1, 63, 65, 200])
def test_pallas_pads_ray_counts(n_rays):
    """Ray counts that are not a multiple of the ray block are padded with
    inactive lanes and cut back: same hits as brute force, input length
    out."""
    from psdr_tpu.accel.pallas_kernel import ray_intersect_pallas

    tris, bvh = _soup_bvh(300, seed=41)
    o, d = _random_rays(n_rays, seed=42)
    hb = ray_intersect_brute(*tris, o, d)
    hp = ray_intersect_pallas(bvh, o, d, ray_block=64)
    assert hp.t.shape == (n_rays,) and hp.uv.shape == (n_rays, 2)
    _assert_same_hits(hb, hp)


@pytest.mark.parametrize("case", ["all_inactive", "tmax_zero"])
def test_pallas_lanes_that_cannot_hit(case):
    """All lanes inactive, or tmax = 0: nothing is hit, in both modes, and
    the miss record is the contract's (id -1, t inf)."""
    from psdr_tpu.accel.pallas_kernel import ray_intersect_pallas

    _, bvh = _soup_bvh(512, seed=43)
    o, d = _random_rays(256, seed=44)
    act = jnp.ones(256, bool)
    tmax = None
    if case == "all_inactive":
        act = jnp.zeros(256, bool)
    else:
        tmax = jnp.zeros(256, jnp.float32)
    for any_hit in (False, True):
        h = ray_intersect_pallas(bvh, o, d, act, tmax=tmax, any_hit=any_hit)
        assert not np.asarray(h.valid).any()
        assert (np.asarray(h.tri_id) == -1).all()
        assert np.isinf(np.asarray(h.t)).all()


def test_pallas_block_tables_cut_the_bvh():
    """The kernel's tables: 2B node rows ending at the block level, skip
    links that stay inside them, and 16 SoA rows per block that hold every
    triangle slot exactly once."""
    from psdr_tpu.accel.pallas_kernel import block_tables

    _, bvh = _soup_bvh(501, seed=45)
    T, B, nodes, skip, tris = block_tables(bvh, 32)
    assert T == 32 and B * T == bvh.num_leaves * bvh.leaf_size
    assert nodes.shape == (2 * B, 8) and skip.shape == (2 * B,)
    assert tris.shape == (16 * B, T)
    assert int(np.asarray(skip).max()) < 2 * B
    rows = np.asarray(tris).reshape(B, 16, T)
    assert int(rows[:, 9].sum()) == 501                 # validity row
    assert not rows[:, 10:].any()                       # zero padding
    # a tri_block beyond the scene collapses to one block; below the leaf
    # size it is raised to one leaf
    assert block_tables(bvh, 1 << 20)[1] == 1
    assert block_tables(bvh, 1)[0] == bvh.leaf_size


@pytest.mark.parametrize("any_hit", [False, True])
def test_pallas_lowers_for_cuda(any_hit, monkeypatch):
    """The kernel lowers through Pallas's Triton route for CUDA on a machine
    without a GPU (catches primitives the route cannot express; the Triton
    compile itself happens on the card)."""
    import psdr_tpu.accel.pallas_kernel as pk

    _, bvh = _soup_bvh(256, seed=46)
    monkeypatch.setattr(pk.jax, "default_backend", lambda: "gpu")
    f = jax.jit(lambda o, d, a, tm: pk.ray_intersect_pallas(
        bvh, o, d, a, tm, any_hit=any_hit))
    spec = [jax.ShapeDtypeStruct((300, 3), jnp.float32)] * 2 + [
        jax.ShapeDtypeStruct((300,), bool),
        jax.ShapeDtypeStruct((300,), jnp.float32)]
    exp = jax.export.export(
        f, platforms=["cuda"],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(*spec)
    assert "__gpu$xla.gpu.triton" in exp.mlir_module()


@pytest.mark.gpu
def test_pallas_compiled_matches_brute():
    """On a GPU the kernel is compiled (never interpreted) and matches
    brute force."""
    from psdr_tpu.accel.pallas_kernel import ray_intersect_pallas

    tris, bvh = _soup_bvh(2048, seed=47)
    o, d = _random_rays(4096, seed=48)
    _assert_same_hits(ray_intersect_brute(*tris, o, d),
                      ray_intersect_pallas(bvh, o, d))


def test_ray_test_sparse_matches_brute():
    """ray_test(sparse=True) — the compacted occlusion sweep with its
    lax.cond fallback — must agree with a direct brute-force occlusion
    answer for sparse activity (compacted path), dense activity (overflow
    -> fallback), and all-inactive lanes."""
    import jax
    from psdr_tpu.scene.scene import ray_test, _ray_test_sparse
    from psdr_tpu.core.records import Ray
    from scenes import cbox_scene

    scene = cbox_scene(width=16, height=16, spp=1)
    scene.accel_mode = "pallas"
    scene.prepare_accel()
    flat = scene.build(scene.params())
    assert flat.accel_kind == "pallas" and flat.accel is not None

    rng = np.random.default_rng(31)
    n = 4096  # == sort segment fallback size; ks = 512 lanes
    o = jnp.asarray(rng.uniform(-0.8, 0.8, (n, 3)), jnp.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True))
    dist = jnp.asarray(rng.uniform(0.1, 3.0, n), jnp.float32)

    from psdr_tpu.core.constants import ShadowEpsilon
    hb = ray_intersect_brute(flat.tri.p0, flat.tri.e1, flat.tri.e2, o, d,
                             jnp.ones(n, bool), tmax=dist - ShadowEpsilon)

    for name, act_np in [("sparse", rng.uniform(size=n) < 0.01),
                         ("dense-fallback", rng.uniform(size=n) < 0.9),
                         ("alloff", np.zeros(n, bool))]:
        act = jnp.asarray(act_np)
        occ = jax.jit(lambda a: ray_test(flat, Ray(o, d), dist, a,
                                         sort_rays=True, sparse=True))(act)
        expect = np.asarray(hb.valid) & act_np
        np.testing.assert_array_equal(np.asarray(occ), expect, err_msg=name)
    # the compacted branch really is selected for sparse activity (fits)
    act = jnp.asarray(rng.uniform(size=n) < 0.01)
    occ2 = jax.jit(lambda a: _ray_test_sparse(
        flat, Ray(o, d), dist - ShadowEpsilon, a))(act)
    np.testing.assert_array_equal(np.asarray(occ2) & np.asarray(act),
                                  np.asarray(hb.valid) & np.asarray(act))
