"""SE(3) pose-graph optimization: robust Levenberg-Marquardt with a dense
(block Cholesky) or an implicit-matvec PCG solve.

Port of ``rgbdslam_v2_tpu/optim/pose_graph.py``: ``GraphState``,
``make_graph_state``, ``_adjoint``, ``_edge_terms``, ``edge_chi2``,
``_build_gradient_and_diag``, ``_hessian_matvec``, ``_pcg``,
``_dense_delta``, ``_chol_solve_6``, ``lm_iteration`` and ``optimize``.

The JAX ``while_loop`` is a Python loop with one host read per iteration
(the convergence flag). ``optimize`` may solve over the first ``n_nodes``
rows and ``n_edges`` edge slots only: nodes beyond them are inactive, held
fixed (``free`` = 0), so they add nothing to the normal equations or to any
PCG dot product and the solution is the same as over the full capacity.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import se3
from ..utils import timing


@dataclasses.dataclass
class GraphState:
    """Fixed-capacity pose graph, updated in place."""

    poses: torch.Tensor  # (N, 4, 4) world_T_node
    node_active: torch.Tensor  # (N,) bool
    node_fixed: torch.Tensor  # (N,) bool
    edge_i: torch.Tensor  # (E,) int32
    edge_j: torch.Tensor  # (E,) int32
    edge_meas: torch.Tensor  # (E, 4, 4) Z ~ X_i^{-1} X_j
    edge_info: torch.Tensor  # (E, 6, 6)
    edge_active: torch.Tensor  # (E,) bool

    def prefix(self, n_nodes: int, n_edges: int) -> "GraphState":
        """Views of the first n_nodes nodes and n_edges edge slots."""
        return GraphState(
            poses=self.poses[:n_nodes], node_active=self.node_active[:n_nodes],
            node_fixed=self.node_fixed[:n_nodes], edge_i=self.edge_i[:n_edges],
            edge_j=self.edge_j[:n_edges], edge_meas=self.edge_meas[:n_edges],
            edge_info=self.edge_info[:n_edges], edge_active=self.edge_active[:n_edges],
        )


def make_graph_state(n_cap: int, e_cap: int, *, device) -> GraphState:
    kw = dict(device=device)
    return GraphState(
        poses=torch.eye(4, **kw).repeat(n_cap, 1, 1),
        node_active=torch.zeros(n_cap, dtype=torch.bool, **kw),
        node_fixed=torch.zeros(n_cap, dtype=torch.bool, **kw),
        edge_i=torch.zeros(e_cap, dtype=torch.int32, **kw),
        edge_j=torch.zeros(e_cap, dtype=torch.int32, **kw),
        edge_meas=torch.eye(4, **kw).repeat(e_cap, 1, 1),
        edge_info=torch.zeros((e_cap, 6, 6), **kw),
        edge_active=torch.zeros(e_cap, dtype=torch.bool, **kw),
    )


def _adjoint(T: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint for twist order [v, w]: [[R, hat(t) R], [0, R]]."""
    R, t = se3.to_rt(T)
    top = torch.cat([R, se3.hat(t) @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _edge_terms(g: GraphState, huber_delta: float):
    """Residuals, Jacobian blocks, Huber-weighted information, chi2."""
    Xi = g.poses[g.edge_i.long()]
    Xj = g.poses[g.edge_j.long()]
    Bm = se3.inv(Xi) @ Xj
    r = se3.log_se3(se3.inv(g.edge_meas) @ Bm)
    Ji = -_adjoint(se3.inv(Bm))
    chi2 = torch.clamp(torch.einsum("ei,eij,ej->e", r, g.edge_info, r), min=0.0)
    d2 = huber_delta * huber_delta
    w = torch.where(chi2 <= d2, 1.0, huber_delta / torch.sqrt(torch.clamp(chi2, min=1e-12)))
    w = torch.where(g.edge_active, w, 0.0)
    info_w = g.edge_info * w[:, None, None]
    return r, Ji, info_w, chi2


def edge_chi2(g: GraphState) -> torch.Tensor:
    """Per-edge chi2 under the current poses (0 for inactive edges)."""
    Xi = g.poses[g.edge_i.long()]
    Xj = g.poses[g.edge_j.long()]
    r = se3.log_se3(se3.inv(g.edge_meas) @ se3.inv(Xi) @ Xj)
    chi2 = torch.einsum("ei,eij,ej->e", r, g.edge_info, r)
    return torch.where(g.edge_active, chi2, 0.0)


def _build_gradient_and_diag(g: GraphState, r, Ji, info_w):
    """b = J^T W r per node and the block diagonal of H, the PCG
    preconditioner's blocks (J_j = I)."""
    N = g.poses.shape[0]
    ei, ej = g.edge_i.long(), g.edge_j.long()
    Ir = torch.einsum("eij,ej->ei", info_w, r)
    bi = torch.einsum("eji,ej->ei", Ji, Ir)
    b = torch.zeros((N, 6), dtype=r.dtype, device=r.device)
    b.index_add_(0, ei, bi).index_add_(0, ej, Ir)
    Hii = torch.einsum("eki,ekl,elj->eij", Ji, info_w, Ji)
    Hdiag = torch.zeros((N, 6, 6), dtype=r.dtype, device=r.device)
    Hdiag.index_add_(0, ei, Hii).index_add_(0, ej, info_w)
    return b, Hdiag


def _hessian_matvec(g: GraphState, Ji, info_w, free, lam_diag, v):
    """Implicit damped H v on (N, 6) vectors (J_j = I); fixed nodes give 0."""
    N = v.shape[0]
    ei, ej = g.edge_i.long(), g.edge_j.long()
    v = v * free[:, None]
    Jv = torch.einsum("eij,ej->ei", Ji, v[ei]) + v[ej]
    WJv = torch.einsum("eij,ej->ei", info_w, Jv)
    oi = torch.einsum("eji,ej->ei", Ji, WJv)
    out = torch.zeros((N, 6), dtype=v.dtype, device=v.device)
    out.index_add_(0, ei, oi).index_add_(0, ej, WJv)
    return (out + lam_diag * v) * free[:, None]


def _pcg(matvec, precond, b, iters: int, tol: float = 1e-6):
    """Preconditioned conjugate gradients on (N, 6) vectors, `iters`
    iterations. As in the JAX scan, a converged state is frozen by masking
    and the host never reads the flag: reading it to stop early saved under
    3% of an online optimize on an H100 (tools/pcg_done_check.py, PERF.md),
    costs a sync a read and would keep the loop out of a CUDA graph."""
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    b2 = torch.sum(b * b) + 1e-30
    done = torch.zeros((), dtype=torch.bool, device=b.device)
    for _ in range(iters):
        Ap = matvec(p)
        pAp = torch.sum(p * Ap)
        alpha = torch.where(pAp > 1e-30, rz / pAp, 0.0)
        x2 = x + alpha * p
        r2 = r - alpha * Ap
        z2 = precond(r2)
        rz2 = torch.sum(r2 * z2)
        beta = torch.where(rz > 1e-30, rz2 / rz, 0.0)
        p2 = z2 + beta * p
        done2 = done | (torch.sum(r2 * r2) <= tol * b2)
        x, r, p, rz = (torch.where(done, old, new)
                       for new, old in ((x2, x), (r2, r), (p2, p), (rz2, rz)))
        done = done2
    return x


def _chol_6(Hb: torch.Tensor) -> torch.Tensor:
    """Batched 6x6 Cholesky factors; NaN where a block is not SPD (as
    jnp.linalg.cholesky gives). cholesky_ex leaves the status on the
    device, so nothing waits for the card here."""
    L, info = torch.linalg.cholesky_ex(Hb)
    return torch.where((info == 0)[:, None, None], L, float("nan"))


def _chol_apply(L: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = v blockwise by two triangular solves."""
    y = torch.linalg.solve_triangular(L, v[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)[..., 0]


def _chol_solve_6(Hb: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched 6x6 SPD solve for the block-Jacobi preconditioner."""
    return _chol_apply(_chol_6(Hb), v)


def _dense_delta(g: GraphState, Ji, info_w, b, free, lam_diag):
    """Assemble the (6N, 6N) normal matrix and solve by Cholesky."""
    N = g.poses.shape[0]
    ei, ej = g.edge_i.long(), g.edge_j.long()
    Hii = torch.einsum("eki,ekl,elj->eij", Ji, info_w, Ji)
    Hij = torch.einsum("eki,ekl->eil", Ji, info_w)  # Ji^T W Jj with Jj = I
    Hblk = torch.zeros((N, N, 6, 6), dtype=b.dtype, device=b.device)
    Hblk.index_put_((ei, ei), Hii, accumulate=True)
    Hblk.index_put_((ej, ej), info_w, accumulate=True)
    Hblk.index_put_((ei, ej), Hij, accumulate=True)
    Hblk.index_put_((ej, ei), Hij.transpose(-1, -2), accumulate=True)
    H = Hblk.permute(0, 2, 1, 3).reshape(6 * N, 6 * N)
    free_flat = free.repeat_interleave(6)
    H = H * free_flat[:, None] * free_flat[None, :]
    damp = lam_diag[:, 0].repeat_interleave(6) * free_flat + (1.0 - free_flat)
    H = H + torch.diag(damp)
    rhs = (-b * free[:, None]).reshape(-1, 1)
    # a failed factorization gives NaN (as LAPACK's does in the reference):
    # the step then counts as not improved and lambda grows
    L, info = torch.linalg.cholesky_ex(H)
    delta = torch.where(info == 0, torch.cholesky_solve(rhs, L), float("nan"))
    return delta.reshape(N, 6) * free[:, None]


def lm_iteration(g: GraphState, lam: torch.Tensor, huber_delta: float = 1.0,
                 pcg_iters: int = 64, solver: str = "pcg"):
    """One LM iteration, solver "dense" or "pcg". Returns (new_poses,
    new_lam, chi2_before, chi2_after)."""
    r, Ji, info_w, chi2_e = _edge_terms(g, huber_delta)
    chi2 = torch.where(g.edge_active, chi2_e, 0.0).sum()
    b, Hdiag = _build_gradient_and_diag(g, r, Ji, info_w)
    free = (g.node_active & ~g.node_fixed).to(r.dtype)
    lam_diag = lam * torch.einsum("nii->n", Hdiag)[:, None] / 6.0 + lam * 1e-3 + 1e-8
    if solver == "dense":
        delta = _dense_delta(g, Ji, info_w, b, free, lam_diag)
    else:
        eye6 = torch.eye(6, dtype=r.dtype, device=r.device)
        Hprec = Hdiag + (lam_diag[:, :, None] + (1.0 - free)[:, None, None]) * eye6
        # the JAX preconditioner refactors Hprec at every CG iteration; the
        # factors are the same each time, so they are computed once here
        L = _chol_6(Hprec)
        delta = _pcg(lambda v: _hessian_matvec(g, Ji, info_w, free, lam_diag, v),
                     lambda v: _chol_apply(L, v) * free[:, None],
                     -b * free[:, None], pcg_iters)
    new_poses = g.poses @ se3.exp_se3(delta)
    chi2_new = edge_chi2(dataclasses.replace(g, poses=new_poses)).sum()
    improved = chi2_new < chi2
    poses_out = torch.where(improved, new_poses, g.poses)
    lam_out = torch.where(improved, torch.clamp(lam * 0.5, min=1e-7),
                          torch.clamp(lam * 4.0, max=1e4))
    return poses_out, lam_out, chi2, torch.where(improved, chi2_new, chi2)


def resolve_solver(solver: str, n_cap: int) -> str:
    """"auto" -> dense up to 1024 nodes of CAPACITY, else PCG (the JAX
    rule: the capacity, not the active prefix, decides)."""
    if solver == "auto":
        return "dense" if n_cap <= 1024 else "pcg"
    if solver not in ("dense", "pcg"):
        raise ValueError(f"unknown solver {solver!r}")
    return solver


def optimize(g: GraphState, iterations: int = 20, huber_delta: float = 1.0,
             pcg_iters: int = 64, chi2_rel_tol: float = 1e-4, solver: str = "auto",
             n_nodes: Optional[int] = None, n_edges: Optional[int] = None,
             read_convergence: bool = True):
    """LM until an accepted step improves chi2 by less than chi2_rel_tol,
    at most `iterations` times. Updates g.poses in place; returns
    (final_chi2 tensor, iterations used). With read_convergence=False the
    host never reads the card: all `iterations` run, and those after
    convergence leave poses, lambda and chi2 as they were (the same result;
    the iteration count returned is then `iterations`)."""
    solver = resolve_solver(solver, g.poses.shape[0])
    n_nodes = g.poses.shape[0] if n_nodes is None else n_nodes
    n_edges = g.edge_i.shape[0] if n_edges is None else n_edges
    sub = g.prefix(n_nodes, n_edges)
    lam = torch.full((), 1e-4, device=g.poses.device)
    chi2 = edge_chi2(sub).sum()
    done = torch.zeros((), dtype=torch.bool, device=g.poses.device)
    it = 0
    while it < iterations:
        # span optimize.lm: one iteration, its convergence read included
        with timing.span("optimize.lm", it):
            poses, lam_new, chi2_before, chi2_new = lm_iteration(sub, lam, huber_delta,
                                                                 pcg_iters, solver)
            it += 1
            rel = (chi2_before - chi2_new) / torch.clamp(chi2_before, min=1e-12)
            # converged only on an ACCEPTED step with a small relative decrease
            # (a rejected step retries with a larger lambda)
            converged = (chi2_new < chi2_before) & (rel < chi2_rel_tol)
            if read_convergence:
                sub.poses.copy_(poses)
                lam, chi2 = lam_new, chi2_new
                if bool(converged):
                    break
            else:
                sub.poses.copy_(torch.where(done, sub.poses, poses))
                lam = torch.where(done, lam, lam_new)
                chi2 = torch.where(done, chi2, chi2_new)
                done = done | converged
    return chi2, it
