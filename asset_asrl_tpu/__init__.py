"""asset_asrl_tpu: a JAX/XLA trajectory-optimization
framework with the capabilities of AlabamaASRL/asset_asrl.

Drop-in namespace layout mirrors the reference python package
(`asset_asrl/__init__.py`):

    import asset_asrl_tpu as ast
    vf = ast.VectorFunctions
    oc = ast.OptimalControl
"""

from . import config  # noqa: F401 -- enables x64 before anything else
from . import VectorFunctions
from . import Solvers
from . import OptimalControl
from . import Astro
from . import Utils
from . import distributed  # noqa: F401 -- multi-host init + meshes

__version__ = "0.4.0"


def SoftwareInfo():
    """Startup banner (reference `src/main.cpp:18-121` SoftwareInfo)."""
    import jax
    devs = ", ".join(str(d) for d in jax.devices())
    print(f"asset_asrl_tpu {__version__} — ASSET on JAX "
          f"(JAX {jax.__version__}; devices: {devs})")

