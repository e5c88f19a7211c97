import os

from . import config

__version__ = "0.1.0"

# one fixed directory per checkout: the cache key includes the path, so a
# directory that moved between runs would never hit
_DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def compilation_cache_dir(environ=os.environ):
    """The persistent XLA compilation cache directory this package sets,
    or None where JAX_COMPILATION_CACHE_DIR is set (JAX reads that
    variable itself, and the package then sets nothing)."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return _DEFAULT_CACHE_DIR


def _enable_compilation_cache() -> None:
    """Keep compiled programs across runs: a cold region compiles the FB,
    the Gibbs sweep and the selection programs, which takes minutes."""
    path = compilation_cache_dir()
    if path is None:
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_enable_compilation_cache()
