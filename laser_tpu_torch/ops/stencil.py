"""Iterative 2-D stencil solvers: Jacobi and red-black Gauss-Seidel (port of
laser_tpu/ops/stencil.py).

``stencil_solve`` runs ``iters`` sweeps of the 5-point Poisson stencil
u[i,j] <- (u[i-1,j] + u[i+1,j] + u[i,j-1] + u[i,j+1] - f[i,j]) / 4 with
fixed (Dirichlet) edges. A red-black iteration updates the red cells,
(r + c) % 2 == 0, from the old grid, then the black cells from the updated
one; a Jacobi sweep updates every interior cell from the previous iterate.

On a CUDA tensor every sweep is the kernel of csrc/stencil.cu
(``stencil_sweeps``: replaces laser_tpu/ops/stencil.py:56
``_build_sweeps``), one launch per half-sweep; on a CPU tensor its plain
version ``stencil_sweeps_plain``, laser_tpu's ``_xla_sweeps`` (:90-102) in
PyTorch. One path for every grid size: laser_tpu's choice between a
VMEM-resident kernel and XLA is a TPU's, and the kernel's source note says
where the grid lives on the H100. The grid's dtype is the computation's, as
in ``_build_sweeps``; a bf16 grid rounds at every op, as PyTorch's eager
ops do. Kernel dtypes: f32, bf16, f16. The result is a new tensor; ``u``
is not modified.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import registry

STENCIL = registry.kernel("stencil_sweep", "laser_tpu_torch/csrc/stencil.cu",
                          "laser_tpu/ops/stencil.py:56 _build_sweeps")

METHODS = ("jacobi", "redblack")
# the kernel's colour argument (csrc/stencil.cu)
_RED, _BLACK, _JACOBI = 0, 1, 2


def _neighbor_sum(u: torch.Tensor) -> torch.Tensor:
    """Sum of the 4 neighbours, ((up + down) + left) + right, zeros outside
    (laser_tpu's ``_neighbor_sum``)."""
    z = torch.zeros_like
    up = torch.cat([z(u[:1]), u[:-1]], 0)
    down = torch.cat([u[1:], z(u[:1])], 0)
    left = torch.cat([z(u[:, :1]), u[:, :-1]], 1)
    right = torch.cat([u[:, 1:], z(u[:, :1])], 1)
    return up + down + left + right


def _masks(shape, device):
    r = torch.arange(shape[0], device=device).reshape(-1, 1)
    c = torch.arange(shape[1], device=device).reshape(1, -1)
    interior = (r > 0) & (r < shape[0] - 1) & (c > 0) & (c < shape[1] - 1)
    return interior, (r + c) % 2 == 0


def stencil_sweeps_plain(u: torch.Tensor, f: torch.Tensor, iters: int,
                         method: str) -> torch.Tensor:
    """The kernel's function in plain PyTorch: laser_tpu's ``_xla_sweeps``,
    the whole grid computed in its dtype and the update kept where the mask
    allows."""
    STENCIL.plain_calls += 1
    interior, red = _masks(u.shape, u.device)
    for _ in range(iters):
        if method == "jacobi":
            u = torch.where(interior, 0.25 * (_neighbor_sum(u) - f), u)
        else:
            u = torch.where(interior & red, 0.25 * (_neighbor_sum(u) - f), u)
            u = torch.where(interior & ~red, 0.25 * (_neighbor_sum(u) - f), u)
    return u if iters else u.clone()


def _sweeps_cuda(u: torch.Tensor, f: torch.Tensor, iters: int, method: str) -> torch.Tensor:
    if u.dtype not in registry.DTYPE_CODES:
        raise NotImplementedError(f"stencil kernel: {u.dtype} grids (f32, bf16, f16)")
    if f.device != u.device:
        raise ValueError(f"stencil: f is on {f.device}, u on {u.device}")
    rows, cols = u.shape
    out = u.contiguous().clone()
    if rows < 3 or cols < 3 or iters == 0:  # no interior, or nothing to do
        return out
    f = f.contiguous()
    lib = registry.load_library()
    code, stream = registry.DTYPE_CODES[u.dtype], registry.stream_handle(u)

    def sweep(src, dst, colour):
        status = lib.ltt_stencil_sweep(src.data_ptr(), f.data_ptr(), dst.data_ptr(), rows, cols,
                                       colour, code, stream)
        registry.check_launch(status, "stencil_sweep")
        STENCIL.launches += 1

    if method == "redblack":
        for _ in range(iters):
            sweep(out, out, _RED)
            sweep(out, out, _BLACK)
        return out
    other = out.clone()
    for _ in range(iters):
        sweep(out, other, _JACOBI)
        out, other = other, out
    return out


def stencil_sweeps(u: torch.Tensor, f: torch.Tensor, iters: int, method: str) -> torch.Tensor:
    """``iters`` sweeps of ``method`` over ``u`` with right-hand side ``f``
    (same shape and dtype): the kernel for a CUDA tensor, the plain
    version for a CPU one. Returns a new grid."""
    if registry.on_cuda(u):
        return _sweeps_cuda(u, f, iters, method)
    return stencil_sweeps_plain(u, f, iters, method)


def stencil_solve(u: torch.Tensor, f: Optional[torch.Tensor] = None, *, iters: int = 1,
                  method: str = "redblack") -> torch.Tensor:
    """Run ``iters`` sweeps of the 5-point Poisson stencil
    u[i,j] <- (u[i-1,j] + u[i+1,j] + u[i,j-1] + u[i,j+1] - f[i,j]) / 4
    with Dirichlet boundaries (edge cells fixed).

    method: "jacobi" | "redblack" (Gauss-Seidel-class convergence). ``f``
    defaults to zeros and is cast to ``u``'s dtype."""
    if method not in METHODS:
        raise ValueError(f"unknown stencil method {method!r}")
    u = torch.as_tensor(u)
    if u.ndim != 2:
        raise ValueError("stencil_solve expects a 2D grid")
    f = torch.zeros_like(u) if f is None else torch.broadcast_to(
        torch.as_tensor(f, device=u.device).to(u.dtype), u.shape)
    return stencil_sweeps(u, f, int(iters), method)
