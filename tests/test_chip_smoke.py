"""chip_smoke.py on the CPU: its phases at a tiny size (the kernel runs in
interpret mode here), and its refusal to run without a GPU."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _tiny(spp=4, sppe=0, sppse=0, accel="pallas"):
    sc = chip_smoke.flagship_scene(32, 32, spp, sppe, sppse,
                                   occluder_subdiv=2)
    sc.accel_mode = accel
    return sc


def _passed(run):
    checks = chip_smoke.Checks("t")
    run(checks)
    assert not checks.failed, checks.failed


def test_main_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


@pytest.mark.parametrize("accel", ["pallas", "culled"])
def test_phase_intersection_tiny(accel):
    _passed(lambda c: chip_smoke.phase_intersection(
        c, _tiny(accel=accel), n_rays=4096))


def test_phase_forward_tiny():
    _passed(lambda c: chip_smoke.phase_forward(c, _tiny(), parity_spp=2))


def test_phase_gradient_tiny():
    _passed(lambda c: chip_smoke.phase_gradient(
        c, _tiny(spp=2, sppe=2, sppse=4), steps=2))


def test_phase_ad_fd_tiny():
    _passed(chip_smoke.phase_ad_fd)


def test_phase_four_cards_tiny():
    _passed(lambda c: chip_smoke.phase_four_cards(
        c, _tiny(spp=2, sppe=2, sppse=2, accel="auto"), n_dev=2,
        mv_size=32))


def test_camera_rays_float64_reference():
    """The float64 camera-ray reference agrees with the device rays to
    float32 precision (the matmuls run at HIGHEST precision)."""
    import jax
    import numpy as np
    from psdr_tpu.sensor.perspective import sample_primary_ray

    sc = _tiny()
    samples = np.random.default_rng(0).uniform(size=(256, 2))
    flat = sc.build(sc.params())
    ray = sample_primary_ray(flat.sensors[0],
                             jax.numpy.asarray(samples, np.float32))
    o64, d64 = chip_smoke.camera_rays_float64(sc, samples)
    np.testing.assert_allclose(np.asarray(ray.o), o64, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ray.d), d64, atol=1e-5)
