"""Linear algebra ops (counterpart of ``paddle_tpu/ops/linalg.py``), with
the JAX package's conventions: ``svd`` returns V (not V^H), ``lu`` 1-based
int32 pivots, ``slogdet`` one tensor ``[sign, log|det|]``, ``cross``'s
default axis the first of size 3, ``norm``'s default the Frobenius norm
over every element."""
from __future__ import annotations

import numpy as np
import torch

from ..core.dispatch import apply
from ..core.tensor import wrap
from .registry import register

__all__ = [
    "matmul", "dot", "bmm", "mm", "mv", "t", "norm", "dist", "einsum",
    "cholesky", "qr", "svd", "inv", "pinv", "solve", "triangular_solve",
    "matrix_power", "matrix_rank", "det", "slogdet", "eig", "eigh",
    "eigvals", "eigvalsh", "lu", "cross", "cov", "corrcoef", "lstsq",
    "multi_dot", "cdist", "householder_product",
]

_reg = register(category="linalg")


@_reg
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def body(a, b):
        if transpose_x and a.dim() > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() > 1:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    return apply(body, x, y, op_name="matmul")


@_reg
def dot(x, y, name=None):
    return apply(lambda a, b: (a * b).sum(-1), x, y, op_name="dot")


@_reg
def bmm(x, y, name=None):
    return apply(torch.bmm, x, y, op_name="bmm")


@_reg
def mm(x, y, name=None):
    return matmul(x, y)


@_reg
def mv(x, vec, name=None):
    return apply(torch.mv, x, vec, op_name="mv")


@_reg
def t(x, name=None):
    return apply(lambda v: v.transpose(0, 1) if v.dim() >= 2
                 else v.view_as(v), x, op_name="t")


@_reg
def norm(x, p=None, axis=None, keepdim=False, name=None):
    def body(v):
        ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
        dims = tuple(range(v.dim())) if ax is None else ax
        if p is None or p == "fro":
            return torch.sqrt(torch.sum(torch.square(v), dims,
                                        keepdim=keepdim))
        if p == "nuc":
            return torch.linalg.svdvals(v).sum(-1)
        if p in (np.inf, float("inf")):
            return torch.amax(torch.abs(v), dims, keepdim=keepdim)
        if p in (-np.inf, float("-inf")):
            return torch.amin(torch.abs(v), dims, keepdim=keepdim)
        if p == 0:
            return torch.sum((v != 0).to(v.dtype), dims, keepdim=keepdim)
        return torch.pow(torch.sum(torch.pow(torch.abs(v), p), dims,
                                   keepdim=keepdim), 1.0 / p)

    return apply(body, x, op_name="norm")


@_reg
def dist(x, y, p=2, name=None):
    return norm(apply(torch.subtract, x, y, op_name="dist"), p=p)


@_reg
def einsum(equation, *operands):
    ops = operands[0] if len(operands) == 1 and \
        isinstance(operands[0], (list, tuple)) else operands
    return apply(lambda *vs: torch.einsum(equation, *vs), *ops,
                 op_name="einsum")


@_reg
def cholesky(x, upper=False, name=None):
    return apply(lambda v: torch.linalg.cholesky(v, upper=upper), x,
                 op_name="cholesky")


@_reg
def qr(x, mode="reduced", name=None):
    return apply(lambda v: tuple(torch.linalg.qr(v, mode=mode)), x,
                 op_name="qr")


@_reg
def svd(x, full_matrices=False, name=None):
    def body(v):
        u, s, vh = torch.linalg.svd(v, full_matrices=full_matrices)
        return u, s, vh.transpose(-1, -2)

    return apply(body, x, op_name="svd")


@_reg
def inv(x, name=None):
    return apply(torch.linalg.inv, x, op_name="inv")


@_reg
def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return apply(lambda v: torch.linalg.pinv(v, rtol=rcond,
                                             hermitian=hermitian), x,
                 op_name="pinv")


@_reg
def solve(x, y, name=None):
    return apply(torch.linalg.solve, x, y, op_name="solve")


@_reg
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    def body(a, b):
        if transpose:
            a, upper_ = a.transpose(-1, -2), not upper
        else:
            upper_ = upper
        return torch.linalg.solve_triangular(a, b, upper=upper_,
                                             unitriangular=unitriangular)

    return apply(body, x, y, op_name="triangular_solve")


@_reg
def matrix_power(x, n, name=None):
    return apply(torch.linalg.matrix_power, x, int(n),
                 op_name="matrix_power")


@_reg
def matrix_rank(x, tol=None, hermitian=False, name=None):
    return apply(lambda v: torch.linalg.matrix_rank(v, rtol=tol), x,
                 op_name="matrix_rank")


@_reg
def det(x, name=None):
    return apply(torch.linalg.det, x, op_name="det")


@_reg
def slogdet(x, name=None):
    def body(v):
        sign, logabs = torch.linalg.slogdet(v)
        return torch.stack([sign, logabs], 0)

    return apply(body, x, op_name="slogdet")


@_reg
def eig(x, name=None):
    w, v = torch.linalg.eig(x.detach().cpu())
    return wrap(w.to(x.device)), wrap(v.to(x.device))


@_reg
def eigh(x, UPLO="L", name=None):
    def body(v):
        v = (v + v.transpose(-1, -2).conj()) / 2     # jax symmetrises
        return tuple(torch.linalg.eigh(v))

    return apply(body, x, op_name="eigh")


@_reg
def eigvals(x, name=None):
    return wrap(torch.linalg.eigvals(x.detach().cpu()).to(x.device))


@_reg
def eigvalsh(x, UPLO="L", name=None):
    return apply(lambda v: torch.linalg.eigvalsh(v, UPLO=UPLO), x,
                 op_name="eigvalsh")


@_reg
def lu(x, pivot=True, get_infos=False, name=None):
    def body(v):
        lufac, piv = torch.linalg.lu_factor(v)
        return lufac, piv.to(torch.int32)   # LAPACK's 1-based pivots

    out = apply(body, x, op_name="lu")
    if get_infos:
        return (*out, wrap(torch.zeros(1, dtype=torch.int32,
                                       device=x.device)))
    return out


@_reg
def cross(x, y, axis=9, name=None):
    def body(a, b):
        ax = axis
        if ax == 9:
            ax = next(i for i, s in enumerate(a.shape) if s == 3)
        return torch.linalg.cross(a, b, dim=int(ax))

    return apply(body, x, y, op_name="cross")


@_reg
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return apply(lambda v: torch.cov(v if rowvar else v.transpose(0, 1),
                                     correction=1 if ddof else 0), x,
                 op_name="cov")


@_reg
def corrcoef(x, rowvar=True, name=None):
    return apply(lambda v: torch.corrcoef(v if rowvar
                                          else v.transpose(0, 1)), x,
                 op_name="corrcoef")


@_reg
def lstsq(x, y, rcond=None, driver=None, name=None):
    def body(a, b):
        sol = torch.linalg.pinv(a) @ b
        sv = torch.linalg.svdvals(a)
        m, n = a.shape[-2], a.shape[-1]
        rank = torch.linalg.matrix_rank(a)
        res = ((a @ sol - b) ** 2).sum(-2) if m > n and int(rank) == n \
            else sol.new_zeros(0)
        return sol, res, rank.to(torch.int64), sv

    return apply(body, x, y, op_name="lstsq")


@_reg
def multi_dot(x, name=None):
    return apply(lambda *vs: torch.linalg.multi_dot(vs), *x,
                 op_name="multi_dot")


@_reg
def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    def body(a, b):
        diff = a[..., :, None, :] - b[..., None, :, :]
        if p == 2.0:
            return torch.sqrt(torch.sum(torch.square(diff), -1) + 1e-30)
        return torch.pow(torch.sum(torch.pow(torch.abs(diff), p), -1),
                         1.0 / p)

    return apply(body, x, y, op_name="cdist")


@_reg
def householder_product(x, tau, name=None):
    return apply(torch.linalg.householder_product, x, tau,
                 op_name="householder_product")
