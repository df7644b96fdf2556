"""Test configuration: the CPU platform with an 8-device virtual mesh.

Multi-device sharding tests run on a virtual CPU mesh
(xla_force_host_platform_device_count=8).  JAX_PLATFORMS defaults to
"cpu"; the tests marked `gpu` run on the card with JAX_PLATFORMS=cuda,cpu
and skip elsewhere (`chip_smoke.py` drives the full GPU path).  This must
run before any jax backend is initialized.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_enable_x64", True)
# No persistent compilation cache: its key does not include the host CPU's
# features, so CPU entries written here could be loaded by another machine
# that receives a copy of the checkout.
jax.config.update("jax_enable_compilation_cache", False)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
