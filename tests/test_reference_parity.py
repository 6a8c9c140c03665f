"""The reference's own test matrix, recreated as golden estimator tests.

psdr-cuda ships 8 named end-to-end tests (examples/config.py:45-167) over 5
scenes; they are its only correctness standard. This module loads the same
scene XMLs (asset paths rewritten; `bunny.obj` is not committed in the
reference repo, so a procedural stand-in is substituted) and checks the
same properties at CPU-sized sample budgets:

* estimator cross-validation (cbox_MIS / cbox_bs / cbox_es): BSDF-only,
  light-only and MIS renders of cbox_bunny.xml converge to the same image;
* multi-emitter (cbox_mutie): same cross-validation on the two-emitter
  scene — light-only sampling goes through the emitter-selection
  distribution (scene.py discrete_sample_reuse over emitters), so any
  selection-pdf bug breaks the agreement;
* AD-vs-FD derivative images for the reference's perturbation configs
  (cbox vertex_transform, tree mesh_rotate secondary-only with no_edge,
  bunny silhouette primary-only two-mesh rotate, envmap rotate);
* secondary-edge guiding measurably reduces estimator variance.
"""
import os

import numpy as np
import jax
import pytest

from psdr_tpu import DirectIntegrator, FieldExtractionIntegrator, RenderOptions
from psdr_tpu.scene.loader import load_file
from psdr_tpu.shape import primitives

_REF = "/root/reference/examples"

pytestmark = pytest.mark.skipif(not os.path.isdir(_REF),
                                reason="reference assets not mounted")


@pytest.fixture(scope="module")
def scenes_dir(tmp_path_factory):
    """Reference scene XMLs with usable asset paths + bunny stand-in."""
    d = tmp_path_factory.mktemp("ref_scenes")
    # the reference repo does not commit bunny.obj (configs use it anyway,
    # run from a checkout with the asset); an icosphere at the same
    # transform slot preserves every property the tests check
    standin = d / "bunny.obj"
    primitives.make_icosphere(subdiv=2, radius=0.8).dump(str(standin))
    for name in ("cbox_bunny.xml", "cbox_bunny_mutiemitter.xml", "tree.xml",
                 "bunny.xml", "bunny_env.xml", "bunny_env_2.xml"):
        xml = open(f"{_REF}/data/scenes/{name}").read()
        xml = xml.replace("./data/objects/bunny/bunny.obj", str(standin))
        xml = xml.replace("./data", f"{_REF}/data")
        (d / name).write_text(xml)
    return d


def _load(scenes_dir, name, width, height, spp, sppe=0, sppse=0):
    sc = load_file(str(scenes_dir / name))
    sc.opts = RenderOptions(width=width, height=height, spp=spp, sppe=sppe,
                            sppse=sppse)
    return sc


def _avg_render(sc, integ, seeds):
    render = jax.jit(integ.render_fn(sc, 0, with_boundary=False))
    imgs = [np.asarray(render(sc.params(), jax.random.PRNGKey(s)))
            for s in range(seeds)]
    return np.mean(imgs, axis=0).reshape(sc.opts.height, sc.opts.width, 3)


def _smooth(img, k=2):
    """Box-filter an image; cross-validation compares expectations, and
    smoothing trades resolution for Monte-Carlo variance."""
    h, w, c = img.shape
    return img[:h - h % k, :w - w % k].reshape(h // k, k, w // k, k, c).mean(
        axis=(1, 3))


def _assert_estimators_agree(a, b, label, tol=0.12):
    sa, sb = _smooth(a), _smooth(b)
    scale = max(sa.mean(), sb.mean(), 1e-6)
    err = np.abs(sa - sb).mean() / scale
    assert err < tol, f"{label}: relative disagreement {err:.3f}"


# ---------------------------------------------------------------------------
# cbox_MIS / cbox_bs / cbox_es: estimator cross-validation
# ---------------------------------------------------------------------------

def test_cbox_estimator_cross_validation(scenes_dir):
    sc = _load(scenes_dir, "cbox_bunny.xml", 40, 40, spp=24)
    mis = _avg_render(sc, DirectIntegrator(2, 2), seeds=3)
    bsdf_only = _avg_render(sc, DirectIntegrator(5, 0), seeds=3)
    light_only = _avg_render(sc, DirectIntegrator(0, 2), seeds=3)
    assert mis.mean() > 0.01 and np.isfinite(mis).all()
    _assert_estimators_agree(mis, light_only, "MIS vs light-only")
    _assert_estimators_agree(mis, bsdf_only, "MIS vs bsdf-only", tol=0.25)


# ---------------------------------------------------------------------------
# cbox_mutie: >= 2 emitters exercises the emitter-selection distribution
# ---------------------------------------------------------------------------

def test_cbox_multiemitter_selection(scenes_dir):
    sc = _load(scenes_dir, "cbox_bunny_mutiemitter.xml", 40, 40, spp=24)
    n_emitters = len(sc.emitters)
    assert n_emitters >= 2, "scene must carry two area emitters"
    mis = _avg_render(sc, DirectIntegrator(2, 2), seeds=3)
    light_only = _avg_render(sc, DirectIntegrator(0, 2), seeds=3)
    assert mis.mean() > 0.01 and np.isfinite(mis).all()
    # light-only goes through emitter selection + its pdf; a selection bug
    # (wrong weight, un-remapped sample) skews it off the MIS estimate
    _assert_estimators_agree(mis, light_only, "multi-emitter NEE vs MIS")


# ---------------------------------------------------------------------------
# AD-vs-FD derivative images (the reference's AD configs, shrunk for CPU)
# ---------------------------------------------------------------------------

def _ad_fd_images(sc, integ, perturbation, eps, seeds, **pk):
    from psdr_tpu.testing.differential import apply_perturbation
    render = integ.render_fn(sc, 0, with_boundary=True)
    render_nb = integ.render_fn(sc, 0, with_boundary=False)
    base = sc.params()

    def f(P, key, r):
        p = jax.tree.map(lambda x: x, base)
        return r(apply_perturbation(perturbation, p, P, **pk), key)

    @jax.jit
    def one_seed(key):
        ad = jax.jvp(lambda P: f(P, key, render), (0.0,), (1.0,))[1]
        ad_nob = jax.jvp(lambda P: f(P, key, render_nb), (0.0,), (1.0,))[1]
        fd = (f(eps, key, render_nb) - f(-eps, key, render_nb)) / (2 * eps)
        return ad, ad_nob, fd

    ads, ads_nob, fds = [], [], []
    for s in range(seeds):
        ad, ad_nob, fd = one_seed(jax.random.PRNGKey(s))
        ads.append(np.asarray(ad))
        ads_nob.append(np.asarray(ad_nob))
        fds.append(np.asarray(fd))
    h, w = sc.opts.height, sc.opts.width
    return (np.mean(ads, axis=0).reshape(h, w, 3),
            np.mean(ads_nob, axis=0).reshape(h, w, 3),
            np.mean(fds, axis=0).reshape(h, w, 3))


def _assert_boundary_closes_gap(ad, ad_nob, fd, label, improve=0.85):
    boundary_part = np.abs(ad - ad_nob).sum()
    assert boundary_part > 0, f"{label}: boundary term contributed nothing"
    err_with = np.abs(_smooth(ad) - _smooth(fd)).sum()
    err_without = np.abs(_smooth(ad_nob) - _smooth(fd)).sum()
    assert err_with < improve * err_without, (
        f"{label}: boundary term does not close the AD-FD gap "
        f"(with={err_with:.4f}, without={err_without:.4f})")


def test_cbox_vertex_transform_ad_fd(scenes_dir):
    """AD_config3: move one emitter vertex; interior + primary + secondary
    terms all react (cbox_MIS / cbox_bs / cbox_es share this config)."""
    sc = _load(scenes_dir, "cbox_bunny.xml", 32, 32, spp=8, sppe=8, sppse=48)
    integ = DirectIntegrator(1, 1)
    ad, ad_nob, fd = _ad_fd_images(
        sc, integ, "vertex_transform", eps=4.0, seeds=4,
        mesh_index=0, vertex_index=0, direction=(-1.0, 0.0, 0.0))
    assert np.abs(ad).max() > 1e-5
    _assert_boundary_closes_gap(ad, ad_nob, fd, "cbox vertex_transform")


@pytest.mark.slow
def test_tree_rotate_secondary_only_ad_fd(scenes_dir):
    """tree test: sppse-only config — the rotating tree's shadow gradient
    comes entirely from the secondary-edge estimator (the tree itself is
    out of frame: interior AD is exactly zero); no_edge disables edges on
    the emitter (0) and ground plane (2), and guiding is enabled as in the
    reference's config (24k tree edges need it)."""
    sc = load_file(str(scenes_dir / "tree.xml"))
    for i in (0, 2):  # reference run_test.py:56-58 no_edge handling
        sc.meshes[i].enable_edges = False
    sc.opts = RenderOptions(width=32, height=32, spp=8, sppe=0, sppse=64)
    integ = DirectIntegrator(0, 2)
    integ.preprocess_secondary_edges(sc, 0, (512, 4, 4, 2), 8)
    ad, ad_nob, fd = _ad_fd_images(
        sc, integ, "mesh_rotate", eps=1.0, seeds=4,
        mesh_index=1, axis=(0.0, 0.0, 1.0))
    assert np.abs(ad_nob).max() < 1e-6  # pure boundary config
    assert np.abs(ad).sum() > 0
    # 24k-edge shadow gradient: assert shape agreement (correlation) and
    # that the boundary term closes most of the AD-FD gap
    sa, sf = _smooth(ad), _smooth(fd)
    corr = np.corrcoef(sa.ravel(), sf.ravel())[0, 1]
    assert corr > 0.4, f"tree boundary gradient decorrelated from FD: {corr}"
    _assert_boundary_closes_gap(ad, ad_nob, fd, "tree mesh_rotate",
                                improve=0.9)


def test_bunny_silhouette_primary_only_ad_fd(scenes_dir):
    """bunny_silhouette: FieldExtraction silhouette AOV, two meshes rotated
    in opposite directions; the gradient is pure primary-boundary."""
    sc = _load(scenes_dir, "bunny.xml", 32, 32, spp=16, sppe=64, sppse=0)
    integ = FieldExtractionIntegrator("silhouette")
    ad, ad_nob, fd = _ad_fd_images(
        sc, integ, "mesh_rotate", eps=1.0, seeds=4,
        mesh_index=[0, 1], axis=[[0.0, 0.1, 0.0], [0.0, -0.1, 0.0]])
    # silhouette is piecewise-constant: interior AD is identically zero
    assert np.abs(ad_nob).max() < 1e-6
    assert np.abs(ad).sum() > 0
    _assert_boundary_closes_gap(ad, ad_nob, fd, "bunny silhouette")


@pytest.mark.slow
def test_bunny_env2_envmap_rotate_ad_fd(scenes_dir):
    """bunny_env_1 config (envmap_rotate, interior-only) applied to the
    committed-asset scene bunny_env_2.xml.

    The raw 1024x512 ballroom map needs ~1600 spp to converge an FD
    comparison (tiny HDR windows sweep across texels; the reference uses
    spp=64 x npass=25). Downfiltering the same asset 16x makes the
    comparison converge at CPU budgets while still exercising the full
    XML -> PIZ -> importance-table -> rotation-gradient path.
    """
    sc = _load(scenes_dir, "bunny_env_2.xml", 24, 24, spp=16)
    em = sc.emitters[0]
    rad = np.asarray(em.radiance.data)
    h, w, _ = rad.shape
    small = rad.reshape(h // 16, 16, w // 16, 16, 3).mean(axis=(1, 3))
    from psdr_tpu.emitter.envmap import EnvironmentMap
    sc.emitters[0] = EnvironmentMap(small, scale=float(em.scale),
                                    to_world=np.asarray(em.to_world))
    integ = DirectIntegrator(2, 2)
    ad, ad_nob, fd = _ad_fd_images(
        sc, integ, "envmap_rotate", eps=1.0, seeds=6,
        emitter_index=0, axis=(0.0, 1.0, 0.0))
    assert np.abs(ad).max() > 1e-5
    # pure interior gradient: AD must track FD in shape and magnitude
    sa, sf = _smooth(ad, 4), _smooth(fd, 4)
    corr = np.corrcoef(sa.ravel(), sf.ravel())[0, 1]
    assert corr > 0.6, f"envmap rotation gradient decorrelated: {corr:.3f}"
    num = np.abs(sa - sf).sum()
    den = np.abs(sf).sum() + 1e-9
    assert num / den < 0.8, f"envmap rotate AD/FD relative error {num/den:.3f}"


# ---------------------------------------------------------------------------
# Guiding: the 3D hypercube warp must reduce secondary-edge variance
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_guiding_reduces_secondary_edge_variance(scenes_dir):
    sc = _load(scenes_dir, "cbox_bunny.xml", 24, 24, spp=0, sppe=0, sppse=32)
    from psdr_tpu.testing.differential import apply_perturbation

    def boundary_grads(integ, n=6):
        render = integ.render_fn(sc, 0, with_boundary=True)
        base = sc.params()
        outs = []
        for s in range(n):
            key = jax.random.PRNGKey(100 + s)

            def f(P):
                p = jax.tree.map(lambda x: x, base)
                return render(apply_perturbation(
                    "vertex_transform", p, P, mesh_index=0, vertex_index=0,
                    direction=(-1.0, 0.0, 0.0)), key)

            outs.append(np.asarray(jax.jvp(f, (0.0,), (1.0,))[1]))
        return np.stack(outs)

    plain = DirectIntegrator(1, 1)
    guided = DirectIntegrator(1, 1)
    guided.preprocess_secondary_edges(sc, 0, (24, 3, 3, 4), 8)

    g_plain = boundary_grads(plain)
    g_guided = boundary_grads(guided)
    # same estimator expectation, lower spread: compare mean per-pixel
    # variance across seeds
    v_plain = g_plain.var(axis=0).mean()
    v_guided = g_guided.var(axis=0).mean()
    assert v_guided < 0.8 * v_plain, (
        f"guiding did not reduce variance: {v_guided:.3e} vs {v_plain:.3e}")


# ---------------------------------------------------------------------------
# bunny_env.xml (the reference's FIRST envmap config): roughconductor bunny
# under a scaled envmap — the second of the two envmap scenes the reference
# ships (examples/config.py:121-147). bunny.obj is not committed upstream;
# the icosphere stand-in preserves every property checked here.
# ---------------------------------------------------------------------------

def test_bunny_env_estimator_cross_validation(scenes_dir):
    sc = _load(scenes_dir, "bunny_env.xml", 32, 32, spp=24)
    mis = _avg_render(sc, DirectIntegrator(1, 1), seeds=4)
    light_only = _avg_render(sc, DirectIntegrator(0, 2), seeds=4)
    bsdf_only = _avg_render(sc, DirectIntegrator(2, 0), seeds=4)
    assert np.isfinite(mis).all() and mis.mean() > 0.01
    _assert_estimators_agree(mis, bsdf_only, "bunny_env MIS vs bsdf-only")
    _assert_estimators_agree(mis, light_only, "bunny_env MIS vs light-only",
                             tol=0.2)


# ---------------------------------------------------------------------------
# High-budget pinned cross-validation: one scanned
# program averages many seeds cheaply, tightening the 12% smoke tolerance
# to 5% — the "matching images" bar at CPU-reachable budgets.
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_cbox_cross_validation_high_budget(scenes_dir):
    import jax.numpy as jnp
    sc = _load(scenes_dir, "cbox_bunny.xml", 40, 40, spp=24)
    params = sc.params()

    def seed_mean(integ, n_seeds=24):
        render = integ.render_fn(sc, 0, with_boundary=False)

        @jax.jit
        def scanned(p, keys):
            def body(acc, k):
                return acc + render(p, k), None
            img, _ = jax.lax.scan(
                body, jnp.zeros((sc.opts.num_pixels, 3), jnp.float32), keys)
            return img / n_seeds

        keys = jax.random.split(jax.random.PRNGKey(11), n_seeds)
        return np.asarray(scanned(params, keys)).reshape(
            sc.opts.height, sc.opts.width, 3)

    mis = seed_mean(DirectIntegrator(2, 2))
    light_only = seed_mean(DirectIntegrator(0, 2))
    _assert_estimators_agree(mis, light_only,
                             "high-budget MIS vs light-only", tol=0.05)
