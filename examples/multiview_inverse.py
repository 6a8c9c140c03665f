"""Multi-view inverse rendering sharded over a device mesh.

BASELINE config 5 at laptop scale: N views of a displaced sphere, one
view per device (``make_multiview_train_step``), mean-over-views L2,
parameter gradients psum'd over the mesh, masked Adam on the mesh
transform. On CPU this runs on 4 emulated devices; on a machine with
several GPUs the same code shards views over the cards.

Usage: python examples/multiview_inverse.py [iters]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "tests"))

if os.environ.get("JAX_PLATFORMS"):
    import jax
    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
    if os.environ["JAX_PLATFORMS"] == "cpu":
        os.environ.setdefault(
            "XLA_FLAGS", "--xla_force_host_platform_device_count=4")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax

from psdr_tpu import DirectIntegrator, PerspectiveCamera
from psdr_tpu.core import transform as xf
from psdr_tpu.parallel import device_mesh
from psdr_tpu.parallel.sharding import make_multiview_train_step
from psdr_tpu.testing.differential import apply_perturbation
from scenes import sphere_light_scene


def main():
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    n_views = min(4, len(jax.devices()))

    sc = sphere_light_scene(width=32, height=32, spp=4)
    sc.opts = dataclasses.replace(sc.opts, sppe=2, sppse=8)
    eyes = ([6.0, 1.5, 0.0], [0.0, 1.5, 6.0], [-6.0, 1.5, 0.0])
    for eye in eyes[:n_views - 1]:
        cam = PerspectiveCamera(fov_x=40.0)
        cam.set_transform(np.asarray(xf.look_at(eye, [0, 0, 0], [0, 1, 0])))
        sc.add_sensor(cam)

    integ = DirectIntegrator(1, 1)
    sc.prepare_accel()
    truth = sc.params()
    targets = [np.asarray(integ.radiance_image(
        sc, sc.build(truth), s, jax.random.PRNGKey(1000 + s), False))
        for s in range(sc.num_sensors)]

    # optimize ONLY the displaced mesh's translation column: the L2 loss
    # also puts (noisy) gradients on the rotation and homogeneous rows of
    # the 4x4, and Adam's per-element normalization would distort those
    # as fast as it recovers the translation
    t_mask = np.zeros((4, 4), np.float32)
    t_mask[0:3, 3] = 1.0
    mask_tree = jax.tree.map(lambda a: jnp.zeros_like(a), truth)
    mask_tree["meshes"][0]["to_world"] = jnp.asarray(t_mask)

    def entrywise_mask(m_tree):
        def init(params):
            return optax.EmptyState()

        def update(updates, state, params=None):
            return jax.tree.map(lambda u, m: u * m, updates, m_tree), state

        return optax.GradientTransformation(init, update)

    optimizer = optax.chain(optax.adam(5e-2), entrywise_mask(mask_tree))
    mesh = device_mesh(n_views)
    step, opt_state = make_multiview_train_step(
        integ, sc, mesh, targets, optimizer=optimizer, with_boundary=True)

    params = apply_perturbation("mesh_transform", truth, 0.8,
                                mesh_index=0, direction=(1.0, 0.0, 0.0))
    for i in range(iters):
        params, opt_state, loss = step(params, opt_state,
                                       jax.random.PRNGKey(i))
        if i % 5 == 0 or i == iters - 1:
            print(f"iter {i:4d}  loss {float(loss):.4e}", flush=True)

    off = jax.tree.leaves(jax.tree.map(
        lambda a, b: jnp.abs(a - b).max(), params["meshes"],
        truth["meshes"]))
    print(f"final max |param - truth| over mesh leaves = "
          f"{max(float(x) for x in off):.4f}", flush=True)


if __name__ == "__main__":
    main()
