"""Smoke test of the render and inverse-rendering path on one GPU.

    python chip_smoke.py              # phases a-d on the first GPU
    python chip_smoke.py --four-cards # sharded steps on four GPUs only

Drives the flagship configuration (the Cornell box with a 20k-triangle
occluder, ``tests/scenes.py`` ``cbox_scene(occluder_subdiv=5)``, 512x512,
``DirectIntegrator(1, 1)``) through the entry points a user calls, on the
card, with the kernels compiled for it:

a. intersection parity: 2^20 tile-ordered camera rays and 2^20
   direction-sorted bounce rays (mixed finite / infinite tmax, ~10%
   inactive lanes) through the production backend and through the plain
   brute-force reference; closest hit, any hit, and the sparse occlusion
   sweep at ~1% active lanes and in its dense fallback;
b. forward render at spp=64 (finite, mean > 0.01), camera rays against
   float64 numpy, and the production image against the brute-force image
   at spp=4 with the same seed;
c. value_and_grad of an L2 loss through the boundary-term render (spp=16,
   sppe=4, sppse=32), every gradient leaf finite, then 3 steps of
   ``make_train_step`` on a one-device mesh;
d. AD against central finite differences on the card (the suite's
   light-translation and albedo cases), relative error < 0.05.

Each phase prints its compared values beside their limits and its compile
and steady-state seconds. Any failed check makes the script exit non-zero.
The last line of a passing run is one JSON object naming the device. With
no GPU, the script exits non-zero before any phase runs.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

WIDTH = HEIGHT = 512
SPP = 64
PARITY_SPP = 4
GRAD_SPP, GRAD_SPPE, GRAD_SPPSE = 16, 4, 32
OCCLUDER_SUBDIV = 5
PARITY_RAYS = 1 << 20
AD_FD_LIMIT = 0.05


class Checks:
    """Collects the compared values of one phase and prints each beside
    its limit."""

    def __init__(self, phase: str):
        self.phase = phase
        self.failed: list[str] = []

    def check(self, name: str, value, limit: str, ok: bool) -> None:
        print(f"  [{self.phase}] {name}: {value} (limit {limit}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            self.failed.append(name)

    def timing(self, name: str, seconds: float) -> None:
        print(f"  [{self.phase}] {name}: {seconds:.4f} s", flush=True)


def _timed(fn, *args, repeat: int = 3):
    """(first-call seconds incl. compile, median steady seconds, output)."""
    import jax
    import numpy as np
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return first, float(np.median(times)) if times else first, out


def flagship_scene(width=WIDTH, height=HEIGHT, spp=SPP, sppe=0, sppse=0,
                   occluder_subdiv=OCCLUDER_SUBDIV):
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from scenes import cbox_scene
    return cbox_scene(width=width, height=height, spp=spp, sppe=sppe,
                      sppse=sppse, occluder_subdiv=occluder_subdiv)


def parity_rays(flat, width, height, spp, n_rays, seed):
    """(camera, bounce) ray sets as (o, d, active, tmax) tuples. Camera rays
    are tile-ordered (``spp`` consecutive lanes per pixel), bounce rays
    leave the camera hits into the upper hemisphere and are sorted by
    direction the way the integrators sort them. Both carry ~10% inactive
    lanes and finite tmax on half the lanes."""
    import jax
    import jax.numpy as jnp
    from psdr_tpu.accel.bruteforce import ray_intersect_brute
    from psdr_tpu.core.records import Ray
    from psdr_tpu.integrator.base import tile_pos_to_pixel
    from psdr_tpu.scene.scene import _octant_sort
    from psdr_tpu.sensor.perspective import sample_primary_ray

    sg = jax.lax.stop_gradient

    @jax.jit
    def make(key):
        k = jax.random.split(key, 6)
        lane = jnp.arange(n_rays, dtype=jnp.int32)
        pix = jnp.minimum(lane // spp, width * height - 1)
        idx = tile_pos_to_pixel(pix, width, height)
        base = jnp.stack([(idx % width).astype(jnp.float32),
                          (idx // width).astype(jnp.float32)], axis=-1)
        samples = ((base + jax.random.uniform(k[0], (n_rays, 2)))
                   / jnp.array([width, height], jnp.float32))
        cam = sample_primary_ray(flat.sensors[0], samples)
        o, d = sg(cam.o), sg(cam.d)

        def lanes(kk):
            act = jax.random.uniform(kk[0], (n_rays,)) > 0.1
            tmax = jnp.where(jax.random.uniform(kk[1], (n_rays,)) > 0.5,
                             jnp.inf,
                             jax.random.uniform(kk[1], (n_rays,),
                                                minval=0.05, maxval=4.0))
            return act, tmax

        cam_act, cam_tmax = lanes(jax.random.split(k[1]))
        hit = ray_intersect_brute(flat.tri.p0, flat.tri.e1, flat.tri.e2,
                                  o, d)
        p = o + d * jnp.where(hit.valid, hit.t, 1.0)[:, None]
        n = flat.tri.face_normal[jnp.maximum(hit.tri_id, 0)]
        w = jax.random.normal(k[2], (n_rays, 3))
        w = w / jnp.linalg.norm(w, axis=1, keepdims=True)
        w = jnp.where((jnp.sum(w * n, axis=1) < 0.0)[:, None], -w, w)
        b_act, b_tmax = lanes(jax.random.split(k[3]))
        b_act = b_act & hit.valid
        perm, _ = _octant_sort(Ray(p, w), b_act, want_inv=False)
        if perm is not None:
            p, w, b_act, b_tmax = p[perm], w[perm], b_act[perm], b_tmax[perm]
        return (o, d, cam_act, cam_tmax), (p, w, b_act, b_tmax)

    return make(jax.random.PRNGKey(seed))


def compare_hits(checks: Checks, name: str, ref, hit, active) -> None:
    """Equal valid masks; equal triangle ids or tied distances (rtol 1e-5,
    the suite's rule); equal any-hit decisions."""
    import numpy as np
    v_ref, v = np.asarray(ref.valid), np.asarray(hit.valid)
    same = np.asarray(ref.tri_id) == np.asarray(hit.tri_id)
    tie = np.isclose(np.asarray(ref.t), np.asarray(hit.t), rtol=1e-5)
    n_valid = int((v_ref != v).sum())
    checks.check(f"{name} valid mismatches", n_valid, "== 0", n_valid == 0)
    n_id = int((~(same | tie) & np.asarray(active)).sum())
    checks.check(f"{name} tri_id mismatches not tied in t", n_id, "== 0",
                 n_id == 0)


def phase_intersection(checks: Checks, scene, n_rays: int = PARITY_RAYS,
                       seed: int = 0):
    """Phase a. ``scene`` must be configured with its production backend."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from psdr_tpu.accel.bruteforce import ray_intersect_brute
    from psdr_tpu.core.constants import ShadowEpsilon
    from psdr_tpu.core.records import Ray
    from psdr_tpu.scene.scene import _closest_hit, ray_test

    scene.prepare_accel()
    flat = scene.build(scene.params())
    checks.check("backend", flat.accel_kind, "production", True)
    opts = scene.opts
    cam, bounce = parity_rays(flat, opts.width, opts.height, opts.spp,
                              n_rays, seed)

    @jax.jit
    def brute(o, d, act, tmax):
        return ray_intersect_brute(flat.tri.p0, flat.tri.e1, flat.tri.e2,
                                   o, d, act, tmax=tmax)

    @jax.jit
    def closest(o, d, act, tmax):
        return _closest_hit(flat, Ray(o, d), act, tmax=tmax)

    @jax.jit
    def any_hit(o, d, act, tmax):
        return _closest_hit(flat, Ray(o, d), act, tmax=tmax, any_hit=True,
                            test_only=True)

    for name, rays in (("camera", cam), ("bounce", bounce)):
        first, steady, hit = _timed(closest, *rays)
        checks.timing(f"{name} closest hit compile+first", first)
        checks.timing(f"{name} closest hit steady", steady)
        ref = jax.block_until_ready(brute(*rays))
        compare_hits(checks, f"{name} closest", ref, hit, rays[2])
        _, steady_a, occ = _timed(any_hit, *rays)
        checks.timing(f"{name} any hit steady", steady_a)
        n_any = int((np.asarray(occ) != np.asarray(ref.valid)).sum())
        checks.check(f"{name} any-hit decision mismatches", n_any, "== 0",
                     n_any == 0)

    # sparse occlusion sweep: ~1% active (compacted path) and ~90% active
    # (segment overflow -> dense fallback), against brute force any hit
    o, d = bounce[0], bounce[1]
    n = o.shape[0]
    dist = jax.random.uniform(jax.random.PRNGKey(seed + 7), (n,),
                              minval=0.05, maxval=3.0)
    ref = brute(o, d, jnp.ones((n,), bool), dist - ShadowEpsilon)
    occl = jax.jit(lambda a: ray_test(flat, Ray(o, d), dist, a,
                                      sort_rays=True, sparse=True))
    for name, frac in (("sparse 1%", 0.01), ("sparse dense-fallback", 0.9)):
        act = jax.random.uniform(jax.random.PRNGKey(seed + 8), (n,)) < frac
        _, steady, occ = _timed(occl, act)
        checks.timing(f"{name} occlusion steady", steady)
        expect = np.asarray(ref.valid) & np.asarray(act)
        n_bad = int((np.asarray(occ) != expect).sum())
        checks.check(f"{name} occlusion mismatches", n_bad, "== 0",
                     n_bad == 0)


def camera_rays_float64(scene, samples):
    """Camera rays for sample-plane points, in float64 numpy from the host
    camera description (the reference for the device's float32 rays)."""
    import numpy as np
    from psdr_tpu.core import transform as xf
    cam = scene.sensors[0]
    to_world = np.asarray(scene.params()["sensors"][0]["to_world"],
                          np.float64)
    aspect = scene.opts.width / scene.opts.height
    camera_to_sample = (
        np.asarray(xf.scale(np.array([-0.5, -0.5 * aspect, 1.0])), np.float64)
        @ np.asarray(xf.translate(np.array([-1.0, -1.0 / aspect, 0.0])),
                     np.float64)
        @ np.asarray(xf.perspective(cam.fov_x, cam.near_clip, cam.far_clip),
                     np.float64))
    s2c = np.linalg.inv(camera_to_sample)
    p = np.concatenate([np.asarray(samples, np.float64),
                        np.zeros((len(samples), 1))], axis=1)
    q = p @ s2c[:3, :3].T + s2c[:3, 3]
    q = q / (p @ s2c[3, :3] + s2c[3, 3])[:, None]
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    d = q @ to_world[:3, :3].T
    o = np.broadcast_to(to_world[:3, 3], d.shape)
    return o, d


def phase_forward(checks: Checks, scene, parity_spp: int = PARITY_SPP,
                  seed: int = 5):
    """Phase b: the flagship forward render through ``renderC``; camera
    rays against float64; production against brute force at
    ``parity_spp``."""
    import jax
    import numpy as np
    from psdr_tpu import DirectIntegrator
    from psdr_tpu.sensor.perspective import sample_primary_ray

    integ = DirectIntegrator(1, 1)
    opts = scene.opts
    first, _, img = _timed(integ.renderC, scene, 0, seed, repeat=0)
    checks.timing("render compile+first", first)
    times = []
    for s in range(3):
        t0 = time.perf_counter()
        img = jax.block_until_ready(integ.renderC(scene, seed=seed + 1 + s))
        times.append(time.perf_counter() - t0)
    steady = float(np.median(times))
    checks.timing("render steady", steady)
    rays = opts.width * opts.height * opts.spp * 3
    print(f"  [b] forward rays/s: {rays / steady:.6e}", flush=True)
    img = np.asarray(img)
    checks.check("image finite", bool(np.isfinite(img).all()), "True",
                 bool(np.isfinite(img).all()))
    checks.check("image mean", float(img.mean()), "> 0.01",
                 float(img.mean()) > 0.01)

    # camera rays: device float32 (HIGHEST-precision transforms) vs float64
    samples = np.random.default_rng(seed).uniform(size=(4096, 2))
    flat = scene.build(scene.params())
    ray = jax.jit(lambda s: sample_primary_ray(flat.sensors[0], s))(
        samples.astype(np.float32))
    o64, d64 = camera_rays_float64(scene, samples)
    err = max(float(np.abs(np.asarray(ray.o) - o64).max()),
              float(np.abs(np.asarray(ray.d) - d64).max()))
    checks.check("camera ray max abs error vs float64", f"{err:.3e}",
                 "< 1e-5", err < 1e-5)

    # production backend against brute force, same seed
    images = {}
    for mode in ("auto", "brute"):
        sc = flagship_scene(opts.width, opts.height, parity_spp,
                            occluder_subdiv=_subdiv_of(scene))
        sc.accel_mode = mode
        images[mode] = np.asarray(integ.renderC(sc, seed=seed))
    a, b = images["auto"], images["brute"]
    bad = ~np.isclose(a, b, rtol=1e-4, atol=1e-5)
    n_bad = int(bad.any(axis=-1).sum())
    checks.check(f"spp={parity_spp} production vs brute pixels outside "
                 "rtol 1e-4 atol 1e-5", n_bad, "== 0", n_bad == 0)


def _subdiv_of(scene) -> int:
    """The occluder subdivision level of a ``cbox_scene``."""
    faces = max(m.num_faces for m in scene.meshes)
    return {20 * 4 ** k: k for k in range(8)}[faces]


def phase_gradient(checks: Checks, scene, steps: int = 3, seed: int = 0):
    """Phase c: value_and_grad through the boundary-term render, all leaves
    finite; then ``steps`` of ``make_train_step`` on a one-device mesh."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from psdr_tpu import DirectIntegrator
    from psdr_tpu.parallel import (device_mesh, make_train_step,
                                   replicate_scene_params)

    integ = DirectIntegrator(1, 1)
    opts = scene.opts
    target = jnp.asarray(integ.renderC(scene, seed=seed + 100)).reshape(-1, 3)
    render = integ.render_fn(scene, with_boundary=True)

    @jax.jit
    def grad_step(params, key):
        def loss(q):
            diff = render(q, key) - target
            return jnp.mean(diff * diff)
        return jax.value_and_grad(loss)(params)

    params = scene.params()
    # a perturbed start so the loss is not at its noise floor
    params["bsdfs"][0] = {"reflectance":
                          params["bsdfs"][0]["reflectance"] * 0.8}
    first, steady, (loss, grads) = _timed(grad_step, params,
                                          jax.random.PRNGKey(seed))
    checks.timing("value_and_grad compile+first", first)
    checks.timing("value_and_grad steady", steady)
    print(f"  [c] grad-samples/s: "
          f"{opts.width * opts.height * opts.spp / steady:.6e}", flush=True)
    leaves = jax.tree.leaves(grads)
    n_bad = sum(int((~np.isfinite(np.asarray(g))).sum()) for g in leaves)
    checks.check("loss finite", float(loss), "finite",
                 bool(np.isfinite(float(loss))))
    checks.check(f"non-finite gradient entries over {len(leaves)} leaves",
                 n_bad, "== 0", n_bad == 0)
    g_abs = sum(float(np.abs(np.asarray(g)).sum()) for g in leaves)
    checks.check("gradient L1 norm", f"{g_abs:.6e}", "> 0", g_abs > 0.0)

    mesh = device_mesh(1)
    step, opt_state = make_train_step(integ, scene, mesh, target)
    # inputs placed the way the step returns them, so that the second
    # step reuses the first step's executable instead of recompiling
    p, opt_state = replicate_scene_params((params, opt_state), mesh)
    losses = []
    for i in range(steps):
        t0 = time.perf_counter()
        p, opt_state, loss_i = step(p, opt_state, jax.random.PRNGKey(i))
        loss_i = float(jax.block_until_ready(loss_i))
        dt = time.perf_counter() - t0
        losses.append(loss_i)
        checks.timing(f"train step {i} (first includes compile)", dt)
    checks.check("train losses finite", losses, "all finite",
                 bool(np.isfinite(losses).all()))


def phase_ad_fd(checks: Checks, size: int = 16, spp: int = 16):
    """Phase d: the suite's AD-vs-FD cases on the default backend."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_gradients import _floor_light_scene, ad_vs_fd
    from scenes import sphere_light_scene
    from psdr_tpu import DirectIntegrator

    sc = _floor_light_scene(width=size, height=size, spp=spp)
    shift = jnp.array([1.0, 0.0, 0.0], jnp.float32)

    def translate_light(params, P):
        mp = params["meshes"][1]
        params["meshes"][1] = {"vertex_positions":
                               mp["vertex_positions"] + P * shift,
                               "to_world": mp["to_world"]}
        return params

    def albedo(params, P):
        params = jax.tree.map(lambda x: x, params)
        refl = params["bsdfs"][0]["reflectance"]
        params["bsdfs"][0] = {"reflectance": refl + P}
        return params

    cases = (("light translation", sc, translate_light,
              DirectIntegrator(0, 1)),
             ("albedo", sphere_light_scene(width=size + 8, height=size + 8,
                                           spp=max(spp // 2, 1)),
              albedo, DirectIntegrator(1, 1)))
    for name, scene, perturb, integ in cases:
        t0 = time.perf_counter()
        ad, fd = ad_vs_fd(scene, perturb, integ, eps=1e-2)
        checks.timing(f"{name} AD+FD", time.perf_counter() - t0)
        rel = float(np.abs(ad - fd).max() / (np.abs(fd).max() + 1e-6))
        checks.check(f"{name} AD vs FD relative error", f"{rel:.3e}",
                     f"< {AD_FD_LIMIT}", rel < AD_FD_LIMIT)
        checks.check(f"{name} AD max", f"{float(np.abs(ad).max()):.3e}",
                     "> 1e-4", float(np.abs(ad).max()) > 1e-4)


def _sgd_matches(checks: Checks, name: str, p0, p1, g_ref, lr) -> None:
    """An SGD step moved every parameter by -lr * (serial gradient), up to
    float32 rounding of the parameters themselves."""
    import jax
    import numpy as np
    g_max = max(float(np.abs(np.asarray(g)).max())
                for g in jax.tree.leaves(g_ref))
    worst = 0.0
    for a, b, g in zip(jax.tree.leaves(p0), jax.tree.leaves(p1),
                       jax.tree.leaves(g_ref)):
        a, b, g = (np.asarray(x, np.float64) for x in (a, b, g))
        floor = 4 * np.finfo(np.float32).eps * (np.abs(a).max() + 1e-30)
        err = np.abs((b - a) + lr * g).max()
        worst = max(worst, err / (lr * g_max + floor))
    checks.check(f"{name}: |step - (-lr * serial grad)| / (lr * max|grad|)",
                 f"{worst:.3e}", "< 1e-3", worst < 1e-3)


def _compile_all(lowered: dict) -> dict:
    """Compile lowered programs concurrently (XLA releases the GIL while it
    compiles); returns the executables under the same keys."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(lowered)) as pool:
        futures = {k: pool.submit(lo.compile) for k, lo in lowered.items()}
        return {k: f.result() for k, f in futures.items()}


def phase_four_cards(checks: Checks, scene, n_dev: int = 4, seed: int = 0,
                     mv_size: int = 256):
    """``make_train_step`` over ``device_mesh(n_dev)`` against its serial
    emulation; ``make_multiview_train_step`` with ``n_dev`` views of the
    flagship geometry (``mv_size``²) against its serial emulation; and the
    per-card placement of both. Interior terms only (``with_boundary``
    False): the boundary terms compile to programs twice the size, and
    the sharding machinery under test is the same. The two sharded steps
    compile and run first, so each card's peak memory is read before the
    serial emulations use the first card; then the two emulations compile.
    Each pair compiles concurrently. SGD keeps the
    comparison linear in the gradient (Adam's first step is sign-like and
    would amplify float noise in near-zero gradients); its rate rides in
    the optimizer state, so it is set after the serial gradient is known
    without recompiling."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    from psdr_tpu import DirectIntegrator, PerspectiveCamera
    from psdr_tpu.core import transform as xf
    from psdr_tpu.parallel import device_mesh, make_train_step
    from psdr_tpu.parallel.sharding import (_select_sensor, _stack_sensors,
                                            make_multiview_train_step,
                                            per_device_render_fn)

    devices = jax.devices()[:n_dev]
    checks.check("devices", len(devices), f"== {n_dev}",
                 len(devices) == n_dev)
    mesh = device_mesh(n_dev)
    integ = DirectIntegrator(1, 1)
    opt = optax.inject_hyperparams(optax.sgd)(learning_rate=1.0)
    key = jax.random.PRNGKey(seed)

    # data-parallel step vs the identical per-device math in a loop
    target = jnp.zeros((scene.opts.num_pixels, 3), jnp.float32)
    params = scene.params()
    g = per_device_render_fn(integ, scene, n_dev, with_boundary=False)

    def serial_loss(q):
        # one traced device body, looped over d (compiles like one render)
        img = jax.lax.map(lambda d: g(q, key, d),
                          jnp.arange(n_dev, dtype=jnp.int32)).mean(axis=0)
        diff = img - target
        return jnp.mean(diff * diff)

    step, state = make_train_step(integ, scene, mesh, target, optimizer=opt,
                                  with_boundary=False)

    # multi-view: one view per card, flagship geometry
    sc = flagship_scene(mv_size, mv_size, scene.opts.spp,
                        occluder_subdiv=_subdiv_of(scene))
    for eye in ([1.5, 0.0, 3.2], [-1.5, 0.0, 3.2], [0.0, 0.6, 3.4])[
            :n_dev - 1]:
        cam = PerspectiveCamera(fov_x=39.0, near=0.01, far=100.0)
        cam.set_transform(np.asarray(xf.look_at(eye, [0, 0, 0], [0, 1, 0])))
        sc.add_sensor(cam)
    sc.prepare_accel()
    targets = [jnp.zeros((sc.opts.num_pixels, 3), jnp.float32)
               for _ in range(sc.num_sensors)]
    target_stack = jnp.stack(targets)
    mv_params = sc.params()

    def mv_serial(q):
        flat = sc.build(q)
        stacked, reso = _stack_sensors(flat.sensors)

        def one(d):
            view = d % sc.num_sensors
            fl = flat._replace(sensors=(_select_sensor(stacked, reso, view),))
            img = integ.radiance_image(sc, fl, 0, jax.random.fold_in(key, d),
                                       False)
            diff = img - target_stack[view]
            return jnp.mean(diff * diff)

        return jax.lax.map(one, jnp.arange(n_dev, dtype=jnp.int32)).mean()

    mv_step, mv_state = make_multiview_train_step(
        integ, sc, mesh, targets, optimizer=opt, with_boundary=False)

    def peaks():
        return [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
                for d in devices]

    t0 = time.perf_counter()
    exe = _compile_all({"step": step.lower(params, state, key),
                        "mv_step": mv_step.lower(mv_params, mv_state, key)})
    checks.timing("trace + concurrent compile of the sharded steps",
                  time.perf_counter() - t0)

    # placement: per-card peak memory right after the sharded steps ran,
    # before anything that runs on the first device alone (the serial
    # emulations) is compiled or run
    print(f"  [4] per-device peak bytes after compile: {peaks()}", flush=True)
    jax.block_until_ready((exe["step"](params, state, key),
                           exe["mv_step"](mv_params, mv_state, key)))
    after = peaks()
    print(f"  [4] per-device peak bytes after the sharded steps: {after}",
          flush=True)
    if devices[0].platform == "cpu":
        print("  [4] per-device peak memory: not reported by CPU devices",
              flush=True)
    else:
        spread = min(after) / max(after) if min(after) > 0 else 0.0
        checks.check("per-device peak memory min/max", f"{spread:.3f}",
                     "> 0.5 (work spread over every card; 0 if a card "
                     "reports no peak)", spread > 0.5)

    t0 = time.perf_counter()
    exe.update(_compile_all({
        "serial": jax.jit(jax.value_and_grad(serial_loss)).lower(params),
        "mv_serial": jax.jit(jax.value_and_grad(mv_serial)).lower(
            mv_params)}))
    checks.timing("trace + concurrent compile of the serial emulations",
                  time.perf_counter() - t0)

    def sgd_rate(p, grads):
        p_max = max(float(np.abs(np.asarray(x)).max())
                    for x in jax.tree.leaves(p))
        g_max = max(float(np.abs(np.asarray(x)).max())
                    for x in jax.tree.leaves(grads))
        return jnp.float32(0.1 * p_max / max(g_max, 1e-30))

    for name, serial, stepper, p0, st in (
            ("sharded step", exe["serial"], exe["step"], params, state),
            ("multi-view step", exe["mv_serial"], exe["mv_step"], mv_params,
             mv_state)):
        loss_ref, g_ref = serial(p0)
        lr = sgd_rate(p0, g_ref)
        st.hyperparams["learning_rate"] = lr
        first, steady, (p1, _, loss1) = _timed(stepper, p0, st, key)
        checks.timing(f"{name} first run", first)
        checks.timing(f"{name} steady", steady)
        err = abs(float(loss1) - float(loss_ref)) / abs(float(loss_ref))
        checks.check(f"{name} loss vs serial (relative)", f"{err:.3e}",
                     "< 1e-4", err < 1e-4)
        _sgd_matches(checks, name, p0, p1, g_ref, float(lr))
        placed = sorted(d.id for d in
                        jax.tree.leaves(p1)[0].sharding.device_set)
        checks.check(f"{name} params placed on devices", placed,
                     f"all {n_dev}", len(placed) == n_dev)


def gpu_description() -> str:
    """``nvidia-smi``'s name and power limit of every card."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi not found"
    out = subprocess.run([exe, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or out.stderr.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded and multi-view "
                         "steps against their serial emulations")
    args = ap.parse_args(argv)

    import jax
    try:
        backend = jax.default_backend()
    except RuntimeError as e:
        backend = f"none ({e})"
    if backend != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's default backend is {backend}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import psdr_tpu  # sets the compile cache before anything compiles

    print(gpu_description(), flush=True)
    print(f"compile cache: {psdr_tpu.compile_cache_dir()}", flush=True)
    devices = jax.devices()
    print(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind} "
          f"({devices[0].platform})", flush=True)
    if args.four_cards:
        if len(devices) < 4:
            print(f"chip_smoke: --four-cards needs 4 GPUs, found "
                  f"{len(devices)}", file=sys.stderr)
            return 2
        phases = [("4", "four-card sharded steps",
                   lambda c: phase_four_cards(
                       c, flagship_scene(spp=GRAD_SPP)))]
        count = 4
    else:
        phases = [
            ("a", "intersection parity",
             lambda c: phase_intersection(c, flagship_scene())),
            ("b", "forward render", lambda c: phase_forward(
                c, flagship_scene())),
            ("c", "gradient and optimisation", lambda c: phase_gradient(
                c, flagship_scene(spp=GRAD_SPP, sppe=GRAD_SPPE,
                                  sppse=GRAD_SPPSE))),
            ("d", "AD against FD", phase_ad_fd),
        ]
        count = 1
    failed = []
    for tag, title, run in phases:
        print(f"phase {tag}: {title}", flush=True)
        checks = Checks(tag)
        t0 = time.perf_counter()
        run(checks)
        verdict = "FAIL" if checks.failed else "pass"
        print(f"phase {tag}: {verdict} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        if checks.failed:
            failed.append((tag, checks.failed))
    if failed:
        print(f"chip_smoke: failed checks: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
