"""Inverse rendering: recover an object's POSITION from a target image.

The flagship PSDR workload (reference docs/inverse_diff_render.rst):
interior gradients alone cannot move a silhouette — the visibility
discontinuity carries the signal — so this runs the full differentiable
pipeline (interior + primary-edge + secondary-edge boundary estimators)
inside an Adam loop.

Usage: python examples/inverse_geometry.py [iters]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "tests"))

if os.environ.get("JAX_PLATFORMS"):
    import jax
    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import jax
import jax.numpy as jnp
import numpy as np
import optax

from psdr_tpu import DirectIntegrator
from psdr_tpu.core import transform as xf
from scenes import sphere_light_scene


def main():
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 60
    sc = sphere_light_scene(width=48, height=48, spp=8, sppe=2, sppse=8)
    integ = DirectIntegrator(1, 1)
    render = jax.jit(integ.render_fn(sc, with_boundary=True))

    target = render(sc.params(), jax.random.PRNGKey(42))
    base = sc.params()

    def params_at(offset):
        p = jax.tree.map(lambda x: x, base)
        m = dict(p["meshes"][0])
        shift = jnp.concatenate([offset, jnp.zeros((1,), jnp.float32)])
        m["to_world"] = xf.matmul(xf.translate(shift), m["to_world"])
        p["meshes"] = list(p["meshes"])
        p["meshes"][0] = m
        return p

    @jax.jit
    def step_grad(offset, key):
        def loss_fn(o):
            img = render(params_at(o), key)
            return jnp.mean((img - target) ** 2)
        return jax.value_and_grad(loss_fn)(offset)

    offset = jnp.array([0.35, -0.25], jnp.float32)   # initial mis-placement
    opt = optax.adam(2e-2)
    state = opt.init(offset)
    print(f"start offset: {np.asarray(offset)} (truth: [0, 0])")
    for it in range(iters):
        loss, g = step_grad(offset, jax.random.PRNGKey(it))
        updates, state = opt.update(g, state)
        offset = optax.apply_updates(offset, updates)
        if it % 10 == 0 or it == iters - 1:
            print(f"iter {it:3d}  loss {float(loss):.3e}  "
                  f"offset {np.asarray(offset)}", flush=True)
    err = float(jnp.linalg.norm(offset))
    print(f"final |offset - truth| = {err:.4f}")


if __name__ == "__main__":
    main()
