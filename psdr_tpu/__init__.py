"""psdr_tpu: a path-space differentiable renderer in JAX (Pallas kernels on
the GPU's Triton route).

Re-designed from scratch with the capabilities of uci-rendering/psdr-cuda:
interior path integrals differentiated by jax.grad, plus explicit primary-
and secondary-edge boundary estimators for visibility-discontinuity
gradients, scaled over device meshes with shard_map.
"""
__version__ = "0.1.0"

import os as _os


def compile_cache_dir() -> str:
    """Where the persistent XLA executable cache lives: the directory named
    by ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it itself),
    else ``.jax_cache`` at the root of the checkout (git-ignored; a fixed
    path, because the path is part of the cache key)."""
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")


def _configure_compile_cache() -> None:
    import jax as _jax
    if "JAX_COMPILATION_CACHE_DIR" not in _os.environ:
        _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    # every entry size: tiny executables recompile often in tests
    _jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


_configure_compile_cache()

from .core.records import RenderOptions
from .scene import Scene
from .scene.loader import load_file, load_string, load_integrator
from .shape import Mesh, load_obj
from .shape import primitives
from .bsdf import Diffuse, RoughConductor
from .emitter import AreaLight, EnvironmentMap
from .sensor import PerspectiveCamera
from . import opt
from .integrator import (DirectIntegrator, FieldExtractionIntegrator,
                         PathTracer)
