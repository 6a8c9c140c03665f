"""Benchmark: forward rays/s and backward grad-samples/s on the flagship
Direct-integrator scene, in one process on one GPU.

Configuration: the Cornell-box-style scene with a 20k-triangle occluder
(``tests/scenes.py`` ``cbox_scene(occluder_subdiv=5)``), 512x512, spp=64,
MIS 1 bsdf + 1 light sample (=> 3 traced rays per camera sample). The
forward metric times ``render_fn(detached=True)`` (renderC semantics with a
per-frame scene rebuild). The backward metric times value_and_grad of an L2
loss through scene build + interior render at spp=16 (geometry + material
gradients), as in an inverse-rendering loop.

Prints the device (platform, device_kind, count, and ``nvidia-smi``'s name
and power limit) on a first line, then one JSON line per metric, each
carrying the device too. Refuses to run without a GPU.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tests"))

WIDTH = HEIGHT = 512
SPP = 64
BWD_SPP = 16
BSDF_SAMPLES = LIGHT_SAMPLES = 1


def _bench(step, args, n_iter):
    import jax
    out = step(*args(0))  # compile + warmup
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for i in range(n_iter):
        out = step(*args(i + 1))
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n_iter


def _device() -> dict:
    import jax
    devices = jax.devices()
    gpu = ""
    if shutil.which("nvidia-smi"):
        gpu = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices),
            "nvidia_smi": gpu.splitlines()[0] if gpu else "not found"}


def main() -> int:
    import jax
    if jax.default_backend() != "gpu":
        print(f"bench.py: needs a GPU; JAX's default backend is "
              f"{jax.default_backend()}", file=sys.stderr)
        return 2
    import jax.numpy as jnp
    from psdr_tpu import DirectIntegrator
    from scenes import cbox_scene

    device = _device()
    print(json.dumps({"device": device}), flush=True)
    integrator = DirectIntegrator(BSDF_SAMPLES, LIGHT_SAMPLES)

    scene = cbox_scene(width=WIDTH, height=HEIGHT, spp=SPP,
                       occluder_subdiv=5)
    render = jax.jit(integrator.render_fn(scene, with_boundary=False,
                                          detached=True))
    params = scene.params()
    dt = _bench(render, lambda i: (params, jax.random.PRNGKey(i)), n_iter=5)
    rays = WIDTH * HEIGHT * SPP * (1 + BSDF_SAMPLES + LIGHT_SAMPLES)
    print(json.dumps({"metric": "forward_rays_per_s", "value": rays / dt,
                      "unit": "rays/s", "device": device}), flush=True)

    scene_b = cbox_scene(width=WIDTH, height=HEIGHT, spp=BWD_SPP,
                         occluder_subdiv=5)
    render_b = integrator.render_fn(scene_b, with_boundary=False)
    params_b = scene_b.params()
    target = jnp.zeros((WIDTH * HEIGHT, 3), jnp.float32)

    @jax.jit
    def grad_step(p, key):
        def loss(q):
            img = render_b(q, key)
            return jnp.mean((img - target) ** 2)
        return jax.value_and_grad(loss)(p)  # full grads: nothing DCE'd

    dt_b = _bench(grad_step, lambda i: (params_b, jax.random.PRNGKey(i)),
                  n_iter=3)
    print(json.dumps({"metric": "backward_grad_samples_per_s",
                      "value": WIDTH * HEIGHT * BWD_SPP / dt_b,
                      "unit": "grad-samples/s", "device": device}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
