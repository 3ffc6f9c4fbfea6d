"""Linear algebra ops (counterpart of ``paddle_tpu/ops/linalg.py``) over
``torch.matmul`` and ``torch.linalg``; no Pallas kernel of the
reference computes any of them."""
from __future__ import annotations

import numpy as np
import torch

from ._helpers import (apply, dims, long, nodiff_op, normalize_axis, op,
                       unwrap, wrap)

__all__ = [
    "matmul", "bmm", "mv", "norm", "dist", "cond", "cholesky",
    "cholesky_solve", "qr", "svd", "svdvals", "eig", "eigh", "eigvals",
    "eigvalsh", "inv", "pinv", "det", "slogdet", "matrix_power",
    "matrix_rank", "solve", "triangular_solve", "lstsq", "lu", "lu_unpack",
    "multi_dot", "histogram", "histogramdd", "bincount", "cov", "corrcoef",
    "matrix_transpose", "householder_product", "pca_lowrank", "cdist",
    "trace",
           "matrix_exp", "svd_lowrank"]


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def impl(a, b):
        if transpose_x and a.ndim > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.ndim > 1:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)
    return op("matmul", impl, x, y)


def bmm(x, y, name=None):
    return op("bmm", torch.bmm, x, y)


def mv(x, vec, name=None):
    return op("mv", torch.mv, x, vec)


def norm(x, p=None, axis=None, keepdim=False, name=None):
    ax = normalize_axis(axis)

    def impl(a):
        d = dims(ax, a.ndim)
        if p is None or p == "fro":
            return torch.sqrt(torch.sum(a * a, dim=d, keepdim=keepdim))
        if p == "nuc":
            return torch.linalg.matrix_norm(a, "nuc", dim=d, keepdim=keepdim)
        if p == float("inf") or p == "inf":
            return torch.amax(torch.abs(a), dim=d, keepdim=keepdim)
        if p == float("-inf"):
            return torch.amin(torch.abs(a), dim=d, keepdim=keepdim)
        if p == 0:
            return torch.sum((a != 0).to(a.dtype), dim=d, keepdim=keepdim)
        return torch.sum(torch.abs(a) ** p, dim=d,
                         keepdim=keepdim) ** (1.0 / p)
    return op("p_norm", impl, x)


def dist(x, y, p=2, name=None):
    def impl(a, b):
        d = (a - b).reshape(-1)
        if p == 0:
            return torch.sum((d != 0).to(d.dtype))
        if p == float("inf"):
            return torch.amax(torch.abs(d))
        if p == float("-inf"):
            return torch.amin(torch.abs(d))
        return torch.sum(torch.abs(d) ** p) ** (1.0 / p)
    return op("dist", impl, x, y)


def cond(x, p=None, name=None):
    return op("cond", lambda a: torch.linalg.cond(a, p), x)


def cholesky(x, upper=False, name=None):
    return op("cholesky", lambda a: torch.linalg.cholesky(a, upper=upper), x)


def cholesky_solve(x, y, upper=False, name=None):
    return op("cholesky_solve",
              lambda b, l: torch.cholesky_solve(b, l, upper=upper), x, y)


def qr(x, mode="reduced", name=None):
    q, r = op("qr", lambda a: tuple(torch.linalg.qr(a, mode=mode)), x)
    return q, r


def svd(x, full_matrices=False, name=None):
    """(U, S, VH) with x = U @ diag(S) @ VH: VH is the conjugate
    TRANSPOSE of V, the reference's convention."""
    return op("svd", lambda a: tuple(torch.linalg.svd(
        a, full_matrices=full_matrices)), x)


def svdvals(x, name=None):
    return op("svdvals", torch.linalg.svdvals, x)


def eig(x, name=None):
    return apply(lambda a: tuple(torch.linalg.eig(a)), (x,))


def eigh(x, UPLO="L", name=None):
    return op("eigh", lambda a: tuple(torch.linalg.eigh(a, UPLO=UPLO)), x)


def eigvals(x, name=None):
    return apply(torch.linalg.eigvals, (x,))


def eigvalsh(x, UPLO="L", name=None):
    return op("eigvalsh", lambda a: torch.linalg.eigvalsh(a, UPLO=UPLO), x)


def inv(x, name=None):
    return op("inverse", torch.linalg.inv, x)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return op("pinv", lambda a: torch.linalg.pinv(
        a, rtol=rcond, hermitian=hermitian), x)


def det(x, name=None):
    return op("determinant", torch.linalg.det, x)


def slogdet(x, name=None):
    def impl(a):
        sign, logdet = torch.linalg.slogdet(a)
        return torch.stack([sign, logdet])
    return op("slogdet", impl, x)


def matrix_power(x, n, name=None):
    return op("matrix_power", lambda a: torch.linalg.matrix_power(a, n), x)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return nodiff_op("matrix_rank", lambda a: torch.linalg.matrix_rank(
        a, atol=tol, rtol=None if tol is None else 0.0,
        hermitian=hermitian), x)


def solve(x, y, name=None):
    return op("solve", torch.linalg.solve, x, y)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    def impl(a, b):
        if transpose:
            a, up = a.transpose(-1, -2), not upper
        else:
            up = upper
        return torch.linalg.solve_triangular(a, b, upper=up,
                                             unitriangular=unitriangular)
    return op("triangular_solve", impl, x, y)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """(solution, residuals, rank, singular values) as numpy's lstsq
    gives them: the minimum-norm solution through the pseudo-inverse
    (singular values below ``rcond`` x the largest cut; by default
    eps x max(m, n)), the squared residual norms when the system is
    overdetermined and of full rank (else empty)."""
    def impl(a, b):
        m, n = a.shape[-2:]
        r = rcond if rcond is not None else \
            torch.finfo(a.dtype).eps * max(m, n)
        sv = torch.linalg.svdvals(a)
        sol = torch.linalg.pinv(a, rtol=r) @ b
        rank = (sv > r * sv[..., :1]).sum(-1)
        if m > n and bool((rank == n).all()):
            res = torch.sum((b - a @ sol) ** 2, dim=-2)
        else:
            res = torch.zeros((0,), dtype=a.dtype, device=a.device)
        return sol, res, rank, sv
    return apply(impl, (x, y))


def lu(x, pivot=True, get_infos=False, name=None):
    def impl(a):
        lu_, piv = torch.linalg.lu_factor(a)
        if get_infos:
            return lu_, piv, torch.zeros((), dtype=torch.int32,
                                         device=a.device)
        return lu_, piv
    return apply(impl, (x,))


def lu_unpack(lu_data, lu_pivots, unpack_ludata=True, unpack_pivots=True,
              name=None):
    def impl(a, piv):
        # torch.lu_unpack does not check its inputs (pivots out of range
        # corrupt memory): LU data is floating, pivots integers in [1, m]
        if not a.is_floating_point() or piv.is_floating_point() or \
                piv.dtype == torch.bool:
            raise TypeError("lu_unpack takes floating LU data and integer "
                            "pivots")
        if tuple(piv.shape) != tuple(a.shape[:-2]) + (min(a.shape[-2:]),) \
                or (piv.numel() and not (1 <= int(piv.min()) and
                                         int(piv.max()) <= a.shape[-2])):
            raise ValueError("lu_unpack: pivots of the wrong shape or out "
                             "of range")
        return tuple(torch.lu_unpack(a, piv.to(torch.int32)))
    return apply(impl, (lu_data, lu_pivots))


def multi_dot(x, name=None):
    return apply(lambda *xs: torch.linalg.multi_dot(list(xs)), tuple(x),
                 op_name="multi_dot")


def histogram(input, bins=100, min=0, max=0, name=None):
    return apply(lambda a: torch.histc(
        a.float(), bins=bins, min=min, max=max).to(torch.int64), (input,),
        differentiable=False)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    t = unwrap(x)
    w = unwrap(weights)
    hist, edges = np.histogramdd(
        wrap(t).numpy(), bins=bins, range=ranges, density=density,
        weights=None if w is None else wrap(w).numpy())
    return (wrap(torch.from_numpy(hist).to(t.device)),
            [wrap(torch.from_numpy(e).to(t.device)) for e in edges])


def bincount(x, weights=None, minlength=0, name=None):
    return apply(lambda a, *w: torch.bincount(
        long(a), weights=w[0] if w else None, minlength=minlength),
        (x,) + (() if weights is None else (weights,)),
        differentiable=False)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    fw, aw = unwrap(fweights), unwrap(aweights)
    return op("cov", lambda a: torch.cov(
        a if rowvar else a.transpose(-1, -2), correction=1 if ddof else 0,
        fweights=fw, aweights=aw), x)


def corrcoef(x, rowvar=True, name=None):
    return op("corrcoef", lambda a: torch.corrcoef(
        a if rowvar else a.transpose(-1, -2)), x)


def matrix_transpose(x, name=None):
    return op("matrix_transpose", lambda a: a.transpose(-1, -2), x)


def householder_product(x, tau, name=None):
    return op("householder_product", torch.linalg.householder_product,
              x, tau)


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    def impl(a):
        k = q if q is not None else min(6, a.shape[-2], a.shape[-1])
        if center:
            a = a - a.mean(dim=-2, keepdim=True)
        u, s, vh = torch.linalg.svd(a, full_matrices=False)
        return u[..., :k], s[..., :k], vh.transpose(-1, -2)[..., :k]
    return apply(impl, (x,))


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    def impl(a, b):
        diff = a[..., :, None, :] - b[..., None, :, :]
        if p == 2.0:
            return torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=-1),
                                          min=0))
        return torch.sum(torch.abs(diff) ** p, dim=-1) ** (1.0 / p)
    return op("cdist", impl, x, y)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return op("trace", lambda a: torch.diagonal(
        a, offset, axis1, axis2).sum(-1), x)


def matrix_exp(x, name=None):
    return op("matrix_exp", torch.linalg.matrix_exp, x)


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    """Randomized low-rank SVD (Halko et al. 2011): subspace iteration
    on a Gaussian sketch drawn from the device's generator."""
    def impl(a, *rest):
        if rest:
            a = a - rest[0]
        mdim, ndim = a.shape[-2:]
        k = min(q if q is not None else 6, mdim, ndim)
        omega = torch.randn(tuple(a.shape[:-2]) + (ndim, k), dtype=a.dtype,
                            device=a.device)
        qmat, _ = torch.linalg.qr(a @ omega)
        for _ in range(niter):
            qz, _ = torch.linalg.qr(a.transpose(-1, -2) @ qmat)
            qmat, _ = torch.linalg.qr(a @ qz)
        u_b, s, vh = torch.linalg.svd(qmat.transpose(-1, -2) @ a,
                                      full_matrices=False)
        return qmat @ u_b, s, vh.transpose(-1, -2)
    args = (x,) + ((M,) if M is not None else ())
    return op("svd_lowrank", impl, *args)
