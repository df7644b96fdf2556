"""Global configuration for the JAX ASSET reimplementation.

The reference (AlabamaASRL/asset_asrl) is a double-precision C++ library; the
interior-point solver needs f64 bookkeeping, so we enable x64 on import.  The
hot KKT factorization path can still run blocks in f32 with iterative
refinement (see solvers/kkt), mirroring the reference's Pardiso refinement
knob (`src/Solvers/PSIOPT.h:146` QPRefSteps).
"""

import os

import jax

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the fused solver programs take long to
# compile, so later runs in the same checkout start warm from a fixed
# directory.  An explicit JAX_COMPILATION_CACHE_DIR wins (JAX reads it
# itself and nothing is set here); otherwise the cache lives at one fixed
# path inside the checkout (listed in .gitignore).
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)

# Default floating point dtype for all solver math.
import jax.numpy as jnp  # noqa: E402

DEFAULT_DTYPE = jnp.float64


def default_dtype():
    return DEFAULT_DTYPE
