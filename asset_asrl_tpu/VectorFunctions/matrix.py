"""Runtime matrix functions inside expressions (vf.RowMatrix / vf.ColMatrix).

Reference: `src/VectorFunctions/CommonFunctions/MatrixFunction.h`,
`MatrixInverse`, `MatrixProduct.h`.  A MatrixFunction is a VectorFunction
whose output is the column-major flattening of an (rows x cols) matrix; matrix
semantics live in its operators.  Usage pattern (CartPole example):
``M = vf.RowMatrix(vec, 2, 2); xdd = M.inverse() * Q``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_DTYPE
from .function import VectorFunction, as_function, _is_numericlike

__all__ = ["MatrixFunction", "RowMatrix", "ColMatrix"]


class MatrixFunction(VectorFunction):
    """VectorFunction with matrix structure; flattened output is column-major
    (matches the reference test expectation
    `test_VectorFunctions/__init__.py:106` flatten("F"))."""

    def __init__(self, fn_mat, irows, rows, cols, name="MatrixFunction"):
        # fn_mat: x -> (rows, cols) jnp matrix
        self._fm = fn_mat
        self.rows, self.cols = int(rows), int(cols)
        super().__init__(
            lambda x: fn_mat(x).reshape(-1, order="F")
            if False else fn_mat(x).T.reshape(-1),
            irows, self.rows * self.cols, name=name)

    def matrix(self, x):
        """Traced (rows, cols) matrix value."""
        return self._fm(x)

    # -------------------------------------------------------------- operators
    def __mul__(self, other):
        fm = self._fm
        if isinstance(other, MatrixFunction):
            if other.rows != self.cols or other.IRows() != self.IRows():
                raise ValueError("matrix product size mismatch")
            gm = other._fm
            return MatrixFunction(
                lambda x: fm(x) @ gm(x),
                self.IRows(), self.rows, other.cols, name="matprod")
        if isinstance(other, VectorFunction):
            if other.ORows() == 1:
                g = other._fn
                return MatrixFunction(
                    lambda x: fm(x) * jnp.atleast_1d(g(x))[0],
                    self.IRows(), self.rows, self.cols, name="matscale")
            if other.ORows() != self.cols or other.IRows() != self.IRows():
                raise ValueError("matrix-vector product size mismatch")
            g = other._fn
            return VectorFunction(
                lambda x: fm(x) @ jnp.atleast_1d(g(x)),
                self.IRows(), self.rows, name="matvec")
        if _is_numericlike(other):
            a = np.asarray(other, dtype=np.float64)
            if a.ndim == 0 or a.size == 1:
                s = float(a.ravel()[0])
                return MatrixFunction(lambda x: fm(x) * s, self.IRows(),
                                      self.rows, self.cols, name="matscale")
            if a.ndim == 1:
                if a.shape[0] != self.cols:
                    raise ValueError("matrix-vector product size mismatch")
                aj = jnp.asarray(a, dtype=DEFAULT_DTYPE)
                return VectorFunction(lambda x: fm(x) @ aj, self.IRows(),
                                      self.rows, name="matvec")
            if a.shape[0] != self.cols:
                raise ValueError("matrix product size mismatch")
            aj = jnp.asarray(a, dtype=DEFAULT_DTYPE)
            return MatrixFunction(lambda x: fm(x) @ aj, self.IRows(),
                                  self.rows, a.shape[1], name="matprod")
        return NotImplemented

    def __rmul__(self, other):
        fm = self._fm
        if _is_numericlike(other) and not isinstance(other, VectorFunction):
            a = np.asarray(other, dtype=np.float64)
            if a.ndim == 0 or a.size == 1:
                s = float(a.ravel()[0])
                return MatrixFunction(lambda x: fm(x) * s, self.IRows(),
                                      self.rows, self.cols, name="matscale")
            aj = jnp.asarray(np.atleast_2d(a), dtype=DEFAULT_DTYPE)
            if aj.shape[1] != self.rows:
                raise ValueError("matrix product size mismatch")
            return MatrixFunction(lambda x: aj @ fm(x), self.IRows(),
                                  aj.shape[0], self.cols, name="matprod")
        if isinstance(other, VectorFunction) and other.ORows() == 1:
            g = other._fn
            return MatrixFunction(
                lambda x: fm(x) * jnp.atleast_1d(g(x))[0],
                self.IRows(), self.rows, self.cols, name="matscale")
        return NotImplemented

    def _mat_add(self, other, sub=False, reverse=False):
        fm = self._fm
        op = jnp.subtract if sub else jnp.add
        if isinstance(other, MatrixFunction):
            if (other.rows, other.cols) != (self.rows, self.cols):
                raise ValueError("matrix sum size mismatch")
            gm = other._fm
            if reverse:
                return MatrixFunction(lambda x: op(gm(x), fm(x)), self.IRows(),
                                      self.rows, self.cols, name="matsum")
            return MatrixFunction(lambda x: op(fm(x), gm(x)), self.IRows(),
                                  self.rows, self.cols, name="matsum")
        if _is_numericlike(other) and not isinstance(other, VectorFunction):
            a = jnp.asarray(np.asarray(other, dtype=np.float64),
                            dtype=DEFAULT_DTYPE)
            a = jnp.broadcast_to(a, (self.rows, self.cols))
            if reverse:
                return MatrixFunction(lambda x: op(a, fm(x)), self.IRows(),
                                      self.rows, self.cols, name="matsum")
            return MatrixFunction(lambda x: op(fm(x), a), self.IRows(),
                                  self.rows, self.cols, name="matsum")
        return NotImplemented

    def __add__(self, other):
        return self._mat_add(other)

    def __radd__(self, other):
        return self._mat_add(other, reverse=True)

    def __sub__(self, other):
        return self._mat_add(other, sub=True)

    def __rsub__(self, other):
        return self._mat_add(other, sub=True, reverse=True)

    def __neg__(self):
        fm = self._fm
        return MatrixFunction(lambda x: -fm(x), self.IRows(),
                              self.rows, self.cols, name="matneg")

    # --------------------------------------------------------------- methods
    def inverse(self):
        if self.rows != self.cols:
            raise ValueError("inverse requires a square matrix")
        fm = self._fm
        n = self.rows
        # closed-form small inverses (2x2/3x3 cofactor inverses fuse into
        # the surrounding elementwise code; no LU custom call)
        if n == 1:
            inv = lambda M: 1.0 / M
        elif n == 2:
            def inv(M):
                det = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
                return jnp.array([[M[1, 1], -M[0, 1]],
                                  [-M[1, 0], M[0, 0]]]) / det
        elif n == 3:
            def inv(M):
                c0 = jnp.cross(M[:, 1], M[:, 2])
                c1 = jnp.cross(M[:, 2], M[:, 0])
                c2 = jnp.cross(M[:, 0], M[:, 1])
                det = jnp.dot(M[:, 0], c0)
                return jnp.stack([c0, c1, c2]) / det
        else:
            def inv(M):
                X = jnp.linalg.inv(M.astype(jnp.float32)).astype(M.dtype)
                eye = jnp.eye(M.shape[0], dtype=M.dtype)
                for _ in range(2):
                    X = X @ (2.0 * eye - M @ X)
                return X
        return MatrixFunction(lambda x: inv(fm(x)), self.IRows(),
                              self.rows, self.cols, name="matinv")

    def transpose(self):
        fm = self._fm
        return MatrixFunction(lambda x: fm(x).T, self.IRows(),
                              self.cols, self.rows, name="mattrans")

    def determinant(self):
        if self.rows != self.cols:
            raise ValueError("determinant requires a square matrix")
        fm = self._fm
        return VectorFunction(
            lambda x: jnp.atleast_1d(jnp.linalg.det(fm(x))),
            self.IRows(), 1, name="matdet")


def RowMatrix(func, rows, cols):
    """Interpret func's output as a (rows, cols) matrix stored row-major."""
    func = as_function(func) if not isinstance(func, VectorFunction) else func
    rows, cols = int(rows), int(cols)
    if func.ORows() != rows * cols:
        raise ValueError("RowMatrix: output size != rows*cols")
    f = func._fn
    return MatrixFunction(
        lambda x: jnp.atleast_1d(f(x)).reshape(rows, cols),
        func.IRows(), rows, cols, name="RowMatrix")


def ColMatrix(func, rows, cols):
    """Interpret func's output as a (rows, cols) matrix stored column-major."""
    func = as_function(func) if not isinstance(func, VectorFunction) else func
    rows, cols = int(rows), int(cols)
    if func.ORows() != rows * cols:
        raise ValueError("ColMatrix: output size != rows*cols")
    f = func._fn
    return MatrixFunction(
        lambda x: jnp.atleast_1d(f(x)).reshape(cols, rows).T,
        func.IRows(), rows, cols, name="ColMatrix")
