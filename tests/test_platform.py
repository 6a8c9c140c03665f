"""What the package decides from its platform: the intersection backend
that ``"auto"`` picks, and where the persistent compile cache lives."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("backend,kind", [("gpu", "pallas"),
                                          ("cpu", "culled")])
def test_auto_backend_choice(backend, kind, monkeypatch):
    """``auto`` picks the Triton kernel on a GPU and the XLA block cull
    elsewhere; the built scene carries that choice."""
    from psdr_tpu.scene import scene as scene_mod
    from scenes import cbox_scene

    monkeypatch.setattr(scene_mod.jax, "default_backend", lambda: backend)
    assert scene_mod.auto_accel_kind() == kind
    sc = cbox_scene(width=8, height=8, spp=1)
    sc.accel_mode = "auto"
    sc.accel_min_faces = 1
    sc.prepare_accel()
    flat = sc.build(sc.params())
    assert flat.accel is not None and flat.accel_kind == kind


@pytest.mark.parametrize("mode", ["pallas", "culled", "bvh_walk"])
def test_explicit_backend_is_kept(mode):
    """An explicit accel_mode is never overridden by the platform."""
    from scenes import cbox_scene
    sc = cbox_scene(width=8, height=8, spp=1)
    sc.accel_mode = mode
    sc.prepare_accel()
    assert sc.build(sc.params()).accel_kind == mode


def _cache_dir_in_fresh_process(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    code = ("import jax, psdr_tpu; "
            "print(jax.config.jax_compilation_cache_dir); "
            "print(psdr_tpu.compile_cache_dir())")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.split()[-2:]


@pytest.mark.parametrize("use_env", [False, True])
def test_compile_cache_location(use_env, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the cache is there and the
    package sets no other; without it, the cache is the fixed, git-ignored
    ``.jax_cache`` at the root of the checkout."""
    want = str(tmp_path / "cache") if use_env else os.path.join(
        ROOT, ".jax_cache")
    got_config, got_fn = _cache_dir_in_fresh_process(
        want if use_env else None)
    assert got_config == want and got_fn == want
    if not use_env:
        ignored = subprocess.run(["git", "check-ignore", "-q", want],
                                 cwd=ROOT).returncode == 0
        assert ignored or not os.path.isdir(os.path.join(ROOT, ".git"))
