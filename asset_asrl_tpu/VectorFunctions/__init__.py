"""asset_asrl_tpu.VectorFunctions — the `vf` namespace.

JAX reimplementation of the reference `asset.VectorFunctions` module
(`src/VectorFunctions/ASSET_VectorFunctions.cpp` bindings).
"""

from .function import (VectorFunction, ScalarFunction, Arguments,
                       ConditionalFunction, Constant, as_function, stack)
from .ops import (sin, cos, tan, arcsin, arccos, arctan, arctan2,
                  sinh, cosh, tanh, sqrt, cbrt, exp, log, log10,
                  abs, sign, squared, cubed, inverse,
                  sum, SumElems, dot, cross, normalize, ifelse,
                  min, max, quatProduct, quatRotate,
                  Scaled, RowScaled, IOScaled)
from .matrix import MatrixFunction, RowMatrix, ColMatrix
from .pyfunc import PyVectorFunction, PyScalarFunction

# ASSET alias: vf.Stack == vf.stack
Stack = stack
from .interp import InterpTable1D, InterpTable2D, InterpTable3D, InterpTable4D
from .rootfinder import ScalarRootFinder, RootFinder
