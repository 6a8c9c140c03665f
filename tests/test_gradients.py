"""AD-vs-finite-difference gradient tests — the reference's own correctness
standard (SURVEY.md §4.1, examples/run_test.py:44-231): forward-mode AD
derivative images must match central finite differences.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from psdr_tpu import DirectIntegrator

from scenes import sphere_light_scene, cbox_scene


def ad_vs_fd(scene, perturb, integ, eps, seed=0, with_boundary=False,
             spp_boost=1):
    """Returns (ad_image, fd_image) for scalar parameter P at 0.

    ``perturb(params, P)`` must return a new params pytree. The same RNG key
    is used for all renders (correlated samples make FD usable at low spp).
    """
    render = integ.render_fn(scene, 0, with_boundary=with_boundary)
    key = jax.random.PRNGKey(seed)

    def f(P):
        # fresh structure each call so perturb may mutate containers freely
        base = jax.tree.map(lambda x: x, scene.params())
        return render(perturb(base, P), key)

    img_ad = jax.jvp(f, (0.0,), (1.0,))[1]
    img_p = f(eps)
    img_n = f(-eps)
    img_fd = (img_p - img_n) / (2 * eps)
    return np.asarray(img_ad), np.asarray(img_fd)


def check_close(ad, fd, rtol=0.05, atol=None):
    scale = np.abs(fd).max()
    if atol is None:
        atol = max(scale * rtol, 1e-6)
    err = np.abs(ad - fd).max()
    assert err <= atol, f"AD vs FD mismatch: max err {err}, scale {scale}"


def test_albedo_gradient():
    """BASELINE.json config 1: albedo gradient only, interior term."""
    sc = sphere_light_scene(width=24, height=24, spp=8)
    integ = DirectIntegrator(1, 1)

    def perturb(params, P):
        params = jax.tree.map(lambda x: x, params)  # copy
        refl = params["bsdfs"][0]["reflectance"]
        params["bsdfs"][0] = {"reflectance": refl + P}
        return params

    ad, fd = ad_vs_fd(sc, perturb, integ, eps=1e-2)
    # reflectance enters eval linearly -> FD is nearly exact
    check_close(ad, fd, rtol=0.02)
    assert np.abs(ad).max() > 1e-3  # gradient is not trivially zero


def test_light_radiance_gradient():
    sc = sphere_light_scene(width=24, height=24, spp=8)
    integ = DirectIntegrator(1, 1)

    def perturb(params, P):
        rad = params["emitters"][0]["radiance"]
        params["emitters"][0] = {"radiance": rad * (1.0 + P)}
        return params

    ad, fd = ad_vs_fd(sc, perturb, integ, eps=1e-2)
    check_close(ad, fd, rtol=0.03)
    assert np.abs(ad).max() > 1e-3


def _floor_light_scene(width=16, height=16, spp=16, offset_light=False):
    """Floor + overhead light, nothing occluding and the light outside the
    camera frustum: the image is a *smooth* function of a light translation,
    so interior-only AD must match FD (no boundary term exists)."""
    import numpy as np
    from psdr_tpu import AreaLight, Diffuse, PerspectiveCamera, RenderOptions, Scene
    from psdr_tpu.core import transform as xf
    from psdr_tpu.shape import primitives

    sc = Scene()
    grey = sc.add_bsdf(Diffuse([0.6, 0.6, 0.6]), "grey")
    floor = primitives.make_quad(size=4.0, bsdf_id=grey, enable_edges=False,
                                 use_face_normals=True)
    floor.set_transform(np.asarray(xf.rotate([1, 0, 0], -90.0)))
    sc.add_mesh(floor)

    light = primitives.make_quad(size=1.0, bsdf_id=-1, enable_edges=False,
                                 use_face_normals=True,
                                 enable_vertex_offset=offset_light)
    light.set_transform(np.asarray(
        xf.translate([0.0, 3.0, 0.0]) @ xf.rotate([1, 0, 0], 90.0)))
    li = sc.add_mesh(light)
    sc.add_emitter(AreaLight([8.0, 8.0, 8.0], mesh_index=li))

    cam = PerspectiveCamera(fov_x=35.0, near=0.1, far=100.0)
    cam.set_transform(np.asarray(xf.look_at([0, 2.0, 0.0], [0, 0, 0], [0, 0, 1])))
    sc.add_sensor(cam)
    sc.opts = RenderOptions(width=width, height=height, spp=spp)
    return sc


def test_light_translation_gradient_interior_smooth():
    """Geometric AD through configure + emitter sampling: light translation
    in a discontinuity-free setup; interior AD == FD."""
    sc = _floor_light_scene(width=16, height=16, spp=16)
    integ = DirectIntegrator(0, 1)  # light sampling only

    shift = jnp.array([1.0, 0.0, 0.0], jnp.float32)

    def perturb(params, P):
        mp = params["meshes"][1]  # the light quad
        params["meshes"][1] = {
            "vertex_positions": mp["vertex_positions"] + P * shift,
            "to_world": mp["to_world"],
        }
        return params

    ad, fd = ad_vs_fd(sc, perturb, integ, eps=1e-2)
    denom = np.abs(fd).max() + 1e-6
    rel = np.abs(ad - fd).max() / denom
    assert rel < 0.05, f"relative error {rel}"
    assert np.abs(ad).max() > 1e-4


def test_light_vertical_translation_gradient():
    """Same setup, translation toward the floor (changes distance + G)."""
    sc = _floor_light_scene(width=12, height=12, spp=16)
    integ = DirectIntegrator(0, 1)

    shift = jnp.array([0.0, 1.0, 0.0], jnp.float32)

    def perturb(params, P):
        mp = params["meshes"][1]
        params["meshes"][1] = {
            "vertex_positions": mp["vertex_positions"] + P * shift,
            "to_world": mp["to_world"],
        }
        return params

    ad, fd = ad_vs_fd(sc, perturb, integ, eps=1e-2)
    denom = np.abs(fd).max() + 1e-6
    rel = np.abs(ad - fd).max() / denom
    assert rel < 0.05, f"relative error {rel}"
    assert np.abs(ad).max() > 1e-4


def test_vertex_offset_gradient():
    """1D vertex-offset mode (reference PSDR_MESH_ENABLE_1D_VERTEX_OFFSET,
    mesh.cpp:226-229): AD through a uniform offset along the light quad's
    vertex normals matches FD. The quad's normals are its plane normal, so
    this is a vertical light translation expressed through the offset leaf.
    """
    sc = _floor_light_scene(width=12, height=12, spp=16, offset_light=True)
    integ = DirectIntegrator(0, 1)

    def perturb(params, P):
        mp = params["meshes"][1]
        params["meshes"][1] = dict(mp, vertex_offset=mp["vertex_offset"] + P)
        return params

    ad, fd = ad_vs_fd(sc, perturb, integ, eps=1e-2)
    denom = np.abs(fd).max() + 1e-6
    rel = np.abs(ad - fd).max() / denom
    assert rel < 0.05, f"relative error {rel}"
    assert np.abs(ad).max() > 1e-4


def test_vertex_offset_shift_bake():
    """shift_vertices (mesh.cpp:346-351) bakes the offset into raw positions
    without moving the world-space geometry, and resets the offset leaf."""
    sc = _floor_light_scene(offset_light=True)
    mesh = sc.meshes[1]
    mesh.vertex_offset = np.full((mesh.num_vertices,), 0.25, np.float32)
    before = np.asarray(mesh.world_positions(mesh.params()))
    mesh.shift_vertices()
    assert np.all(np.asarray(mesh.vertex_offset) == 0.0)
    after = np.asarray(mesh.world_positions(mesh.params()))
    np.testing.assert_allclose(before, after, rtol=1e-5, atol=1e-6)


def test_known_hit_recompute_degenerate_lane_grads_finite():
    """A caller-provided hit (known-triangle camera trace) can mark a lane
    valid whose recompute ray is near-coplanar with the triangle; the
    solid-angle re-intersection must stay finite there so a 0-cotangent on
    the masked lane can never poison the psum'd gradient (0 * NaN is
    NaN)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from psdr_tpu.accel.bruteforce import HitRecord
    from psdr_tpu.core.records import Ray
    from psdr_tpu.scene.scene import ray_intersect
    from scenes import cbox_scene

    sc = cbox_scene(width=8, height=8, spp=1)
    params = sc.params()

    def f(p):
        flat = sc.build(p)
        n = 4
        o = jnp.array([[0.0, 0.0, 5.0]] * n)
        # lane 0: honest ray at the scene; lanes 1-3: parallel/grazing to
        # whatever triangle 0 is — degenerate recompute with valid=True
        d = jnp.array([[0.0, 0.0, -1.0],
                       [1.0, 0.0, 0.0],
                       [0.0, 1.0, 1e-8],
                       [1e-8, 1.0, 0.0]])
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        hit = HitRecord(valid=jnp.ones((n,), bool),
                        tri_id=jnp.zeros((n,), jnp.int32),
                        uv=jnp.zeros((n, 2)), t=jnp.ones((n,)))
        its = ray_intersect(flat, Ray(o, d), jnp.ones((n,), bool), hit=hit)
        # consume every differentiable field the boundary AD term touches,
        # masked exactly like the estimator (zero cotangent on junk lanes)
        mask = (its.t < 10.0)[..., None]
        return jnp.sum(jnp.where(mask, its.p, 0.0)) + jnp.sum(
            jnp.where(mask[..., 0], its.t, 0.0))

    g = jax.grad(f)(params)
    leaves = jax.tree.leaves(g)
    assert all(np.isfinite(np.asarray(l)).all() for l in leaves)


def test_inplane_translate_interior_gradient_is_zero():
    """Analytic pin: translating an untextured constant-albedo quad WITHIN
    its own plane presents the identical surface (same plane, same normal,
    same material), so the interior gradient is exactly zero — the whole
    signal lives in the silhouette boundary term. Out-of-plane translation
    of the same setup must be nonzero. Guards against accidentally routing
    visibility gradients into the interior estimator (they belong to the
    edge terms), and documents that a mesh_transform FD-vs-interior-AD
    mismatch on such a mesh is physics, not a bug."""
    from psdr_tpu.core import transform as xf
    from scenes import cbox_scene

    sc = cbox_scene(width=12, height=12, spp=4)
    base = sc.params()
    integ = DirectIntegrator(1, 1)
    render = integ.render_fn(sc, 0, with_boundary=False)

    def img_tw(P, i, d):
        p2 = dict(base)
        p2["meshes"] = list(base["meshes"])
        mp = dict(base["meshes"][i])
        mp["to_world"] = xf.translate(jnp.asarray(d, jnp.float32) * P) \
            @ mp["to_world"]
        p2["meshes"][i] = mp
        return render(p2, jax.random.PRNGKey(3))

    # mesh 0 = floor (y = -1 plane): x-translate is in-plane -> exactly 0
    g_floor = jax.jacfwd(lambda P: img_tw(P, 0, (1.0, 0.0, 0.0)))(
        jnp.float32(0.0))
    assert float(jnp.abs(g_floor).max()) == 0.0

    # mesh 3 = left wall (x = -1 plane): x-translate is along its normal
    # -> shading changes, interior gradient nonzero
    g_wall = jax.jacfwd(lambda P: img_tw(P, 3, (1.0, 0.0, 0.0)))(
        jnp.float32(0.0))
    assert float(jnp.abs(g_wall).max()) > 1e-3


def test_north_star_gradient_pin_1e4():
    """BASELINE.json's north-star gradient bar: "matching gradients to
    1e-4". Smooth interior config (light translated toward its plane
    normal component -> smooth irradiance change) with common random
    numbers: AD and central FD agree to ~8e-5 relative (measured); pinned
    at 2e-4 with margin. Any regression in the differentiable build ->
    render -> recompute chain (J factors, masked divisions, detach
    placement) breaks this long before the 5% smoke tolerances."""
    sc = _floor_light_scene(width=16, height=16, spp=16)
    shift = jnp.array([1.0, 0.0, 0.0], jnp.float32)

    def perturb(params, P):
        mp = params["meshes"][1]
        params["meshes"][1] = {
            "vertex_positions": mp["vertex_positions"] + P * shift,
            "to_world": mp["to_world"]}
        return params

    ad, fd = ad_vs_fd(sc, perturb, DirectIntegrator(0, 1), eps=1e-2)
    rel = np.abs(ad - fd).max() / (np.abs(fd).max() + 1e-12)
    assert rel < 2e-4, f"north-star gradient agreement degraded: {rel:.2e}"
