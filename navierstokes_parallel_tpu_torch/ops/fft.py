"""Direct spectral pressure solve (method="fft"): the DCT-II diagonalizes
the Neumann Laplacian.

PyTorch counterpart of ``navierstokes_parallel_tpu/ops/fft.py``.  The
pressure-Poisson system the reference iterates on with SOR
(integration.c:129-173) is the constant-coefficient 5-point Laplacian with
homogeneous Neumann BCs on a cell-centered grid.  Its eigenvectors are the
DCT-II cosines v_k(i) = cos(pi k (i+1/2)/n), with eigenvalues
lambda_k = (2 cos(pi k / n) - 2) / dx^2, so one forward transform, a
pointwise divide and one inverse transform solve it directly, to rounding.

The transforms are Makhoul's evaluation through one real FFT of the
even-odd permuted sequence (the JAX package's "rfft" route):
``torch.fft.rfft`` / ``irfft``, cuFFT on the card.  The JAX package runs
them with ``jnp.fft`` outside any Pallas kernel, so a library FFT is their
counterpart here.  Left out (ROADMAP "Left out of the port"): the
dense-matrix route on the TPU's MXU, the race between the two routes and
``fft_precision`` (a precision of the MXU's matmuls): any value but
"highest" is refused.

Transforms run in f32; plugged into the f64 refinement outer of ops/sor.py,
the f64 defect mops up their rounding, so the reference contract is met in
2-3 direct solves per step, which ``iterations`` counts.  The Neumann
problem is singular (constant null space); the discrete RHS is compatible
by construction, so zeroing the k = (0, 0) mode selects the minimum-norm
solution.

``make_sharded_inner`` is the pencil decomposition of the sharded backend:
four tiled all-to-alls over the mesh's axis groups re-lay the grid so that
every 1-D transform is local to a rank.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from ..config import Params


def check_precision(params: Params) -> None:
    """Refuse an fft_precision the port does not honour: the transforms are
    full-f32 FFTs, the JAX package's "highest"."""
    if params.fft_precision != "highest":
        raise NotImplementedError(
            f"fft_precision={params.fft_precision!r} (the precision of the "
            f"TPU's MXU matmul route) is not ported: ROADMAP A, \"Left out "
            f"of the port\"; the transforms run in full float32")


@functools.lru_cache(maxsize=None)
def _eigenvalues(n: int, d2_inv: float) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    return ((2.0 * np.cos(np.pi * k / n) - 2.0) * d2_inv).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _twiddle(n: int) -> np.ndarray:
    """exp(-i pi k / 2n) for k = 0..n//2 (f64 phase, stored complex64)."""
    k = np.arange(n // 2 + 1, dtype=np.float64)
    return np.exp(-1j * np.pi * k / (2.0 * n)).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _twiddle_on(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_twiddle(n)).to(device)


def _dct2_rfft(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal DCT-II along the last axis via one real FFT."""
    n = x.shape[-1]
    v = torch.cat([x[..., 0::2], torch.flip(x[..., 1::2], dims=(-1,))],
                  dim=-1)
    Z = _twiddle_on(n, x.device) * torch.fft.rfft(v, dim=-1)
    head = 2.0 * Z.real                     # k = 0 .. n//2
    ntail = n - (n // 2 + 1)                # k = n//2+1 .. n-1 (= X[n-k])
    tail = torch.flip(-2.0 * Z[..., 1:ntail + 1].imag, dims=(-1,))
    X = torch.cat([head, tail], dim=-1) * np.float32(np.sqrt(1.0 / (2.0 * n)))
    X[..., 0] *= np.float32(np.sqrt(0.5))
    return X


def _idct2_irfft(X: torch.Tensor) -> torch.Tensor:
    """Inverse of _dct2_rfft (orthonormal DCT-III) along the last axis."""
    n = X.shape[-1]
    h = (n + 1) // 2
    m = n // 2 + 1
    c = X * np.float32(np.sqrt(2.0 * n))
    c[..., 0] *= np.float32(np.sqrt(2.0))
    # c_rev[k] = c[n-k] for k >= 1
    c_rev = torch.cat([torch.zeros_like(c[..., :1]),
                       torch.flip(c, dims=(-1,))[..., :m - 1]], dim=-1)
    V = torch.conj(_twiddle_on(n, X.device)) * (c[..., :m] - 1j * c_rev) * 0.5
    v = torch.fft.irfft(V, n=n, dim=-1)
    head, tail = v[..., :h], torch.flip(v[..., h:], dims=(-1,))
    # Interleave the even and odd output slots: stack + reshape; odd n pads
    # the (one shorter) odd half, then trims.
    if n % 2 == 0:
        return torch.stack([head, tail], dim=-1).reshape(*v.shape[:-1], n)
    tail = torch.cat([tail, torch.zeros_like(tail[..., :1])], dim=-1)
    return torch.stack([head, tail], dim=-1).reshape(
        *v.shape[:-1], n + 1)[..., :n]


def _solve_rfft(rhs_int: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """The DCT solve over the last two axes (a leading batch axis of
    independent problems is carried through)."""
    rhat = _dct2_rfft(_dct2_rfft(rhs_int).transpose(-2, -1))
    phat = rhat.transpose(-2, -1) / lam
    phat[..., 0, 0] = 0.0  # singular constant mode -> zero mean
    return _idct2_irfft(
        _idct2_irfft(phat.transpose(-2, -1)).transpose(-2, -1))


@functools.lru_cache(maxsize=32)
def _lambda_grid(params: Params) -> np.ndarray:
    """The eigenvalue denominator lam_i + lam_j, 1 where it is 0."""
    lam = (_eigenvalues(params.i_max, 1.0 / (params.dx * params.dx))[:, None]
           + _eigenvalues(params.j_max, 1.0 / (params.dy * params.dy))[None, :])
    return np.where(lam == 0, np.float32(1.0), lam)


@functools.lru_cache(maxsize=32)
def _lambda_on(params: Params, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_lambda_grid(params)).to(device)


def poisson_solve_dct(rhs_int: torch.Tensor, params: Params) -> torch.Tensor:
    """Solve A p = rhs (interior (i_max, j_max), Neumann, zero-mean) in one
    shot: p = C_i^T [ (C_i rhs C_j^T) / (lam_i + lam_j) ] C_j, each
    transform through one real FFT."""
    check_precision(params)
    return _solve_rfft(rhs_int.to(torch.float32),
                       _lambda_on(params, rhs_int.device))


def inner_direct(rhs_neg_full: torch.Tensor, n_solves: int,
                 params: Params) -> torch.Tensor:
    """Refinement inner: `n_solves` chained direct solves of
    A delta = rhs_neg, the defect re-evaluated in f32 between solves (delta
    is small-scale, so the f32 residual has no cancellation floor).
    n_solves = fft_solves_per_outer through the outer's K.  A batch of
    fields (a leading member axis) solves each member."""
    from . import sor  # sor imports this module

    f32 = torch.float32
    device = rhs_neg_full.device
    rhs_int = rhs_neg_full[..., 1:-1, 1:-1].to(f32)
    delta = torch.zeros(rhs_neg_full.shape, dtype=f32, device=device)
    if params.fft_solves_per_outer == 1:
        # One solve, no defect pass.
        delta[..., 1:-1, 1:-1] = poisson_solve_dct(rhs_int, params)
        return delta
    dx2 = torch.tensor(1.0 / (params.dx * params.dx), dtype=f32, device=device)
    dy2 = torch.tensor(1.0 / (params.dy * params.dy), dtype=f32, device=device)
    for _ in range(int(n_solves)):
        # A delta - rhs with the Neumann ghost closure; solve the correction
        # system A e = -(A delta - rhs) and accumulate.
        res = sor.residual(sor.ghost_fill(delta.clone()), rhs_int, dx2, dy2)
        delta[..., 1:-1, 1:-1] += poisson_solve_dct(-res, params)
    return delta


def _all_to_all(x: torch.Tensor, group, size: int, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    """JAX's tiled ``all_to_all(x, axis, split_axis, concat_axis)`` over a
    group of `size` ranks: chunk j of x along split_dim goes to group rank
    j, and the chunks received are concatenated along concat_dim in group
    rank order.  The chunks are made contiguous (a chunk along dim 1 is
    strided); a group of one rank is the identity."""
    if size == 1:
        return x
    send = [t.contiguous() for t in x.chunk(size, dim=split_dim)]
    recv = [torch.empty_like(t) for t in send]
    dist.all_to_all(recv, send, group=group)
    return torch.cat(recv, dim=concat_dim)


def make_sharded_inner(params: Params, li: int, lj: int, mesh):
    """The pencil-decomposed direct solve on block-sharded interiors:
    ``inner_fn(rhs_neg_full, n) -> delta_full`` on this rank's (li+2, lj+2)
    block, one direct solve per call.

    Four tiled all-to-alls: j-pencils out (over "y"), j-pencils -> i-pencils
    over the whole mesh (the combined ("x", "y") axis, whose index is the
    rank ax*py + ay), i-pencils -> j-pencils, j-pencils -> blocks; the
    eigenvalue divide runs in the i-pencil layout, where this rank's global
    j modes are [k*w, (k+1)*w), k its rank, w = nj / (px*py).  The
    interior must divide evenly over the mesh and the pencils must tile
    (li % py == 0, lj % px == 0)."""
    check_precision(params)
    ni, nj = params.i_max, params.j_max
    px, py = mesh.shape
    if px * li != ni or py * lj != nj:
        raise ValueError(
            f"sharded fft requires an evenly-divisible grid; {ni}x{nj} "
            f"does not tile into {li}x{lj} blocks")
    if li % py != 0 or lj % px != 0:
        raise ValueError(
            f"sharded fft pencil decomposition needs li % py == 0 and "
            f"lj % px == 0; got blocks {li}x{lj} on a {px}x{py} mesh")
    device = mesh.device
    w = nj // (px * py)  # i-pencil j-mode width (== lj // px)
    k = mesh.coords[0] * py + mesh.coords[1]
    lam_i = torch.from_numpy(_eigenvalues(ni, 1.0 / (params.dx * params.dx)))
    lam_j = torch.from_numpy(_eigenvalues(nj, 1.0 / (params.dy * params.dy)))
    lam = (lam_i[:, None] + lam_j[k * w:(k + 1) * w][None, :]).to(device)
    lam = torch.where(lam == 0, torch.ones((), dtype=lam.dtype, device=device),
                      lam)
    y_group, y_size = mesh.axis_group("y")
    xy_group, xy_size = mesh.axis_group("xy")

    def inner_fn(rhs_neg_full: torch.Tensor, _n: int) -> torch.Tensor:
        r = rhs_neg_full[1:-1, 1:-1].to(torch.float32)  # (li, lj)
        # Forward transform along j: j-pencils (li // py, nj).
        xj = _dct2_rfft(_all_to_all(r, y_group, y_size, 0, 1))
        # j-pencils -> i-pencils (ni, w) in one transpose over the whole
        # mesh: rows arrive in rank order, which is ascending global i.
        xi = _all_to_all(xj, xy_group, xy_size, 1, 0)
        xi = _dct2_rfft(xi.transpose(0, 1)).transpose(0, 1) / lam
        if k == 0:
            xi[0, 0] = 0.0  # the singular (0, 0) constant mode
        # Inverse along i, back to j-pencils, inverse along j, to blocks.
        xi = _idct2_irfft(xi.transpose(0, 1)).transpose(0, 1)
        xj = _idct2_irfft(_all_to_all(xi, xy_group, xy_size, 0, 1))
        d = _all_to_all(xj, y_group, y_size, 1, 0)
        out = torch.zeros(rhs_neg_full.shape, dtype=torch.float32,
                          device=device)
        out[1:-1, 1:-1] = d
        return out

    return inner_fn


def pencils_tile(params: Params, mesh_shape) -> bool:
    """Whether the pencil decomposition runs on this grid and mesh: the
    interior divides the mesh evenly and the pencils tile."""
    px, py = mesh_shape
    ni, nj = params.i_max, params.j_max
    return (ni % px == 0 and nj % py == 0 and (ni // px) % py == 0
            and (nj // py) % px == 0)


def make_gspmd_inner(params: Params, li: int, lj: int, mesh):
    """The gspmd backend's inner_fn(rhs_neg_full, n) -> delta on this
    rank's (li + 2, lj + 2) block: ``inner_direct``'s n direct solves, with
    the f32 defect between them when ``fft_solves_per_outer`` > 1.

      * Where the pencils tile (``pencils_tile``), each solve is the
        pencil decomposition (``make_sharded_inner``) and the defect is
        taken on the exchanged blocks.
      * Elsewhere (a grid that does not divide the mesh, or pencils that
        do not tile) the rhs is all-gathered and every rank runs the
        one-device ``inner_direct`` on the whole grid, then keeps its
        block."""
    from ..parallel import halo
    from . import mg, sor

    f32 = torch.float32
    if not pencils_tile(params, mesh.shape):
        dims = (params.i_max, params.j_max)

        def gathered(rhs_neg_full: torch.Tensor, n: int) -> torch.Tensor:
            g = rhs_neg_full.new_zeros(params.shape)
            g[1:-1, 1:-1] = mg.gather_interior(rhs_neg_full[1:-1, 1:-1],
                                               mesh, dims)
            d = inner_direct(g, n, params)
            out = torch.zeros(rhs_neg_full.shape, dtype=f32,
                              device=rhs_neg_full.device)
            out[1:-1, 1:-1] = mg.cut_interior(d[1:-1, 1:-1], mesh, li, lj)
            return out

        return gathered
    solve = make_sharded_inner(params, li, lj, mesh)
    if params.fft_solves_per_outer == 1:
        return solve
    dx2 = torch.tensor(1.0 / (params.dx * params.dx), dtype=f32,
                       device=mesh.device)
    dy2 = torch.tensor(1.0 / (params.dy * params.dy), dtype=f32,
                       device=mesh.device)

    def pencils(rhs_neg_full: torch.Tensor, n: int) -> torch.Tensor:
        rhs_int = rhs_neg_full[1:-1, 1:-1].to(f32)
        delta = torch.zeros(rhs_neg_full.shape, dtype=f32,
                            device=rhs_neg_full.device)
        corr = torch.zeros_like(delta)
        for _ in range(int(n)):
            res = sor.residual(halo.neumann_or_exchange(delta, mesh),
                               rhs_int, dx2, dy2)
            corr[1:-1, 1:-1] = -res
            delta[1:-1, 1:-1] += solve(corr, 1)[1:-1, 1:-1]
        return delta

    return pencils

