"""Pose-graph optimization on SE(3) over submap nodes (port of
lis_slam_tpu/graph/pose_graph.py; replaces the reference's GTSAM/iSAM2
back end: addOdomFactor :4189-4214, addGPSFactor :4217-4301, addLoopFactor
:4304-4342, correctPoses :4346-4385 of subMapOptmizationNode.cpp).

Levenberg-Marquardt over the whole graph with dense (6N)^2 normal
equations, the GNC-annealed Cauchy kernel on loop edges, and the JAX
package's early exit (a tiny proposed step once the anneal has reached its
final scale, accepted or not, see ADVICE.md: a step that damping has
shrunk can end the loop too). The `lax.while_loop` is a host loop with
one device->host read per sweep (the exit flag); the accept/reject and the
damping stay on the device. The block scatter-add of H sums repeated node
indices with `index_put_(accumulate=True)`, whose order on CUDA is
atomic, so results agree with the JAX package to rounding, not bitwise.

Nodes as 4x4 matrices with the right perturbation X <- X exp(delta);
between-factor residual r = log(Z^-1 X_i^-1 X_j), J_i = -Ad((X_i^-1
X_j)^-1), J_j = I. `GraphBuilder` pads nodes/edges/priors to the JAX
package's power-of-two buckets so both solve the same-sized system.

`optimize_cg` solves the same objective matrix-free (block-Jacobi
preconditioned CG over the sparse block Hessian) for graphs past
`dense_max_nodes`: GraphConfig.solver "cg", or "auto" past that size. Like
the JAX package's `fori_loop`s it runs a fixed number of LM sweeps and CG
steps, so it never reads back from the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import GraphConfig
from ..utils import lin, se3


class PoseGraph(NamedTuple):
    """Fixed-capacity graph tensors (padded)."""

    nodes: torch.Tensor  # (N, 4, 4)
    node_mask: torch.Tensor  # (N,)
    edge_i: torch.Tensor  # (E,) int64
    edge_j: torch.Tensor  # (E,)
    edge_z: torch.Tensor  # (E, 4, 4)
    edge_weight: torch.Tensor  # (E, 6) per-axis sqrt information
    edge_mask: torch.Tensor  # (E,)
    edge_robust: torch.Tensor  # (E,) Cauchy/GNC kernel (loop edges)
    prior_idx: torch.Tensor  # (P,)
    prior_z: torch.Tensor  # (P, 4, 4)
    prior_weight: torch.Tensor  # (P, 6)
    prior_mask: torch.Tensor  # (P,)


def empty_graph(max_nodes: int, max_edges: int, max_priors: int,
                device: torch.device | str = "cpu") -> PoseGraph:
    """A graph of the given capacities with nothing in it (identity poses
    and measurements, unit weights, every mask False), in GraphBuilder's
    dtypes."""
    def eye(n):
        return torch.eye(4, device=device).expand(n, 4, 4).clone()

    def zeros(n, dtype):
        return torch.zeros(n, dtype=dtype, device=device)

    return PoseGraph(
        nodes=eye(max_nodes), node_mask=zeros(max_nodes, torch.bool),
        edge_i=zeros(max_edges, torch.int64),
        edge_j=zeros(max_edges, torch.int64), edge_z=eye(max_edges),
        edge_weight=torch.ones((max_edges, 6), device=device),
        edge_mask=zeros(max_edges, torch.bool),
        edge_robust=zeros(max_edges, torch.bool),
        prior_idx=zeros(max_priors, torch.int64), prior_z=eye(max_priors),
        prior_weight=torch.ones((max_priors, 6), device=device),
        prior_mask=zeros(max_priors, torch.bool))


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint for twist order [rho, w]: (..., 6, 6)."""
    R = T[..., :3, :3]
    tR = se3.hat(T[..., :3, 3]) @ R
    top = torch.cat([R, tR], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _residuals_and_blocks(graph: PoseGraph, nodes: torch.Tensor):
    """Between-factor residuals (E, 6) + Jacobian blocks (E, 6, 6) x 2."""
    Xi, Xj = nodes[graph.edge_i], nodes[graph.edge_j]
    rel = se3.transform_inverse(Xi) @ Xj
    r = se3.se3_log(se3.transform_inverse(graph.edge_z) @ rel)
    Jj = torch.eye(6, dtype=r.dtype, device=r.device).expand(
        r.shape[0], 6, 6)
    Ji = -adjoint(se3.transform_inverse(rel))
    w = graph.edge_weight
    return r * w, Ji * w[:, :, None], Jj * w[:, :, None]


def _prior_residuals(graph: PoseGraph, nodes: torch.Tensor):
    Xp = nodes[graph.prior_idx]
    r = se3.se3_log(se3.transform_inverse(graph.prior_z) @ Xp)
    J = torch.eye(6, dtype=r.dtype, device=r.device).expand(r.shape[0], 6, 6)
    w = graph.prior_weight
    return r * w, J * w[:, :, None]


def _masked_residuals(graph: PoseGraph, nodes: torch.Tensor):
    r_e, Ji, Jj = _residuals_and_blocks(graph, nodes)
    r_p, Jp = _prior_residuals(graph, nodes)
    em = graph.edge_mask.to(nodes.dtype)
    pm = graph.prior_mask.to(nodes.dtype)
    return (r_e * em[:, None], Ji * em[:, None, None], Jj * em[:, None, None],
            r_p * pm[:, None], Jp * pm[:, None, None])


def _robust_scale(r_e, robust, c: float):
    """IRLS sqrt-weight of the Cauchy kernel rho(e2) = c^2 log(1 + e2/c^2):
    w = 1/(1 + e2/c^2) on robust edges, 1 elsewhere."""
    e2 = torch.sum(r_e * r_e, dim=1)
    w = 1.0 / (1.0 + e2 / (c * c))
    return torch.where(robust, torch.sqrt(w), torch.ones_like(w))


def _robust_cost(graph: PoseGraph, r_e, r_p, c: float):
    e2 = torch.sum(r_e * r_e, dim=1)
    ce = torch.where(graph.edge_robust, c * c * torch.log1p(e2 / (c * c)), e2)
    return torch.sum(ce) + torch.sum(r_p * r_p)


def _gnc_c(it: int, c_final: float, c_start: float) -> float:
    """Graduated non-convexity: the kernel scale halves per sweep from
    c_start down to c_final (exact in float32: c_start * 2^-it)."""
    return max(c_final, c_start * 0.5 ** it)


def _block(J1, J2):
    return torch.einsum("eki,ekj->eij", J1, J2)


def optimize(graph: PoseGraph, damping: float = 1e-6, iterations: int = 20,
             robust_c: float = 3.0, gnc_start_c: float = 1e3) -> PoseGraph:
    """LM over the whole graph, on the graph's device; returns the graph
    with updated nodes. Exits once a proposed step moves every node by
    < 1e-6, but not before the GNC anneal reaches robust_c (+3 sweeps).
    Host syncs: one per sweep."""
    n = graph.nodes.shape[0]
    dev, dt = graph.nodes.device, graph.nodes.dtype
    min_sweeps = min(iterations, int(math.ceil(math.log2(
        max(gnc_start_c / robust_c, 1.0)))) + 3)
    ii, jj, pi = graph.edge_i, graph.edge_j, graph.prior_idx
    active = graph.node_mask.to(dt).repeat_interleave(6)
    mask6 = graph.node_mask[:, None].to(dt)
    nodes = graph.nodes
    lam = torch.tensor(1e-4, dtype=dt, device=dev)
    for it in range(iterations):
        c = _gnc_c(it, robust_c, gnc_start_c)
        r_e, Ji, Jj, r_p, Jp = _masked_residuals(graph, nodes)
        cost = _robust_cost(graph, r_e, r_p, c)
        s = _robust_scale(r_e, graph.edge_robust, c)
        r_e = r_e * s[:, None]
        Ji = Ji * s[:, None, None]
        Jj = Jj * s[:, None, None]
        # assemble H (N, N, 6, 6) and b (N, 6) by block scatter-add
        H = torch.zeros((n, n, 6, 6), dtype=dt, device=dev)
        H.index_put_((ii, ii), _block(Ji, Ji), accumulate=True)
        H.index_put_((jj, jj), _block(Jj, Jj), accumulate=True)
        H.index_put_((ii, jj), _block(Ji, Jj), accumulate=True)
        H.index_put_((jj, ii), _block(Jj, Ji), accumulate=True)
        H.index_put_((pi, pi), _block(Jp, Jp), accumulate=True)
        b = torch.zeros((n, 6), dtype=dt, device=dev)
        b.index_put_((ii,), torch.einsum("eki,ek->ei", Ji, r_e),
                     accumulate=True)
        b.index_put_((jj,), torch.einsum("eki,ek->ei", Jj, r_e),
                     accumulate=True)
        b.index_put_((pi,), torch.einsum("eki,ek->ei", Jp, r_p),
                     accumulate=True)
        Hd = H.permute(0, 2, 1, 3).reshape(6 * n, 6 * n)
        # gauge fix for inactive nodes + LM damping scaled by the diagonal
        Hd = Hd + torch.diag(damping + lam * (torch.diagonal(Hd) + 1.0)
                             + (1.0 - active) * 1e6 + 1e-8)
        delta = -torch.linalg.solve(Hd, b.reshape(6 * n)).reshape(n, 6)
        delta = delta * mask6
        cand = nodes @ se3.se3_exp(delta)
        r_e2, _, _, r_p2, _ = _masked_residuals(graph, cand)
        accept = _robust_cost(graph, r_e2, r_p2, c) < cost
        nodes = torch.where(accept, cand, nodes)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9), lam * 4.0)
        if it + 1 >= min_sweeps and bool(torch.amax(torch.abs(delta)) < 1e-6):
            break
    return graph._replace(nodes=nodes)


def optimize_cg(graph: PoseGraph, damping: float = 1e-6,
                iterations: int = 20, cg_iters: int = 96,
                robust_c: float = 3.0, gnc_start_c: float = 1e3
                ) -> PoseGraph:
    """Matrix-free LM: the objective, GNC schedule and accept/reject of
    `optimize`, but each normal-equation solve is `cg_iters` steps of
    block-Jacobi preconditioned CG over the sparse Hessian's 6x6 blocks
    (O(E) per step; H is never formed). All `iterations` sweeps run, as in
    the JAX package (no early exit).

    The JAX package applies the preconditioner by solving each node's
    damped diagonal block at every CG step; here those blocks are inverted
    once per sweep with utils/lin.solve6_spd_batched (the same
    Schur-complement solve, against the identity), so a step applies them
    with one batched product. The Hessian product gathers both ends of
    every edge, applies each edge's (12, 12) block, and scatters edges and
    priors in one index_add: ~20 tensor ops a CG step."""
    n = graph.nodes.shape[0]
    dev, dt = graph.nodes.device, graph.nodes.dtype
    ii, jj, pi = graph.edge_i, graph.edge_j, graph.prior_idx
    ends = torch.cat([ii, jj])
    rows = torch.cat([ends, pi])
    n_e = ii.shape[0]
    active = graph.node_mask.to(dt)[:, None]
    eye6 = torch.eye(6, dtype=dt, device=dev)
    nodes = graph.nodes
    lam = torch.tensor(1e-4, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    def scatter(vals):
        """Sum rows of (edge i ends, edge j ends, priors) onto the nodes."""
        return torch.zeros((n,) + vals.shape[1:], dtype=dt,
                           device=dev).index_add_(0, rows, vals)

    for it in range(iterations):
        c = _gnc_c(it, robust_c, gnc_start_c)
        r_e, Ji, Jj, r_p, Jp = _masked_residuals(graph, nodes)
        cost = _robust_cost(graph, r_e, r_p, c)
        s = _robust_scale(r_e, graph.edge_robust, c)
        r_e = r_e * s[:, None]
        J = torch.cat([Ji, Jj], 2) * s[:, None, None]  # (E, 6, 12)
        He = _block(J, J)  # (E, 12, 12): [[Hii, Hij], [Hji, Hjj]]
        Hpp = _block(Jp, Jp)
        ge = torch.einsum("eki,ek->ei", J, r_e)
        b = scatter(torch.cat([ge[:, :6], ge[:, 6:],
                               torch.einsum("eki,ek->ei", Jp, r_p)]))
        # diagonal blocks (the preconditioner) + the damping and gauge-fix
        # diagonal of the dense path
        D = scatter(torch.cat([He[:, :6, :6], He[:, 6:, 6:], Hpp]))
        dvec = (damping + lam * (torch.diagonal(D, dim1=1, dim2=2) + 1.0)
                + (1.0 - active) * 1e6 + 1e-8)
        Dd = D + torch.diag_embed(dvec)
        Dinv = lin.solve6_spd_batched(Dd[:, None].expand(n, 6, 6, 6),
                                      eye6.expand(n, 6, 6)).transpose(1, 2)

        def matvec(x):
            xe = x[ends].reshape(2, n_e, 6).permute(1, 0, 2).reshape(n_e, 12)
            ye = (He @ xe[..., None])[..., 0]
            yp = (Hpp @ x[pi][..., None])[..., 0]
            return dvec * x + scatter(torch.cat([ye[:, :6], ye[:, 6:], yp]))

        # PCG for H delta = -b from x = 0; converged solves freeze (rz ~ 0)
        r = -b
        z = (Dinv @ r[..., None])[..., 0]
        rz = torch.sum(r * z)
        x, p = torch.zeros_like(r), z
        for _ in range(cg_iters):
            live = rz > 1e-20
            Ap = matvec(p)
            alpha = torch.where(
                live, rz / torch.clamp(torch.sum(p * Ap), min=1e-30), zero)
            x = x + alpha * p
            r = r - alpha * Ap
            z = (Dinv @ r[..., None])[..., 0]
            rz_new = torch.sum(r * z)
            beta = torch.where(live, rz_new / torch.clamp(rz, min=1e-30),
                               zero)
            p = z + beta * p
            rz = rz_new
        cand = nodes @ se3.se3_exp(x * active)
        r_e2, _, _, r_p2, _ = _masked_residuals(graph, cand)
        accept = _robust_cost(graph, r_e2, r_p2, c) < cost
        nodes = torch.where(accept, cand, nodes)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9), lam * 4.0)
    return graph._replace(nodes=nodes)


class GraphBuilder:
    """Host-side incremental graph (the iSAM2 update pattern: a node + odom
    factor per submap, loop factors, GPS priors), solved on `device` by
    the dense LM and on `cg_device` (default `device`) by optimize_cg."""

    def __init__(self, cfg: GraphConfig, max_nodes: int = 256,
                 max_edges: int = 1024, max_priors: int = 256,
                 device: torch.device | str = "cpu",
                 cg_device: torch.device | str | None = None):
        self.cfg = cfg
        self.max_nodes = max_nodes
        self.max_edges = max_edges
        self.max_priors = max_priors
        self.device = torch.device(device)
        self.cg_device = self.device if cg_device is None else torch.device(
            cg_device)
        self.nodes: list[np.ndarray] = []
        self.edges: list[tuple] = []
        self.priors: list[tuple] = []

    def add_node(self, T_init: np.ndarray) -> int:
        idx = len(self.nodes)
        self.nodes.append(np.asarray(T_init, np.float32))
        if idx == 0:
            w = 1.0 / self.cfg.prior_sigma
            self.priors.append((0, self.nodes[0], np.full(6, w, np.float32)))
        return idx

    def add_odom_edge(self, i: int, j: int, z: np.ndarray):
        w = np.concatenate([np.full(3, 1.0 / self.cfg.odom_trans_sigma),
                            np.full(3, 1.0 / self.cfg.odom_rot_sigma)])
        self.edges.append((i, j, np.asarray(z, np.float32),
                           w.astype(np.float32), False))

    def add_loop_edge(self, i: int, j: int, z: np.ndarray,
                      scale: float = 1.0):
        """Loop edges carry the GNC-Cauchy kernel when cfg.robust_loops."""
        s = max(scale, 1e-3)
        w = np.concatenate([np.full(3, 1.0 / (self.cfg.loop_trans_sigma / s)),
                            np.full(3, 1.0 / (self.cfg.loop_rot_sigma / s))])
        self.edges.append((i, j, np.asarray(z, np.float32),
                           w.astype(np.float32), bool(self.cfg.robust_loops)))

    def add_gps_prior(self, i: int, T: np.ndarray, sigma_xyz: np.ndarray):
        w = np.concatenate([1.0 / np.maximum(sigma_xyz, 1e-3), np.zeros(3)])
        self.priors.append((i, np.asarray(T, np.float32),
                            w.astype(np.float32)))

    @staticmethod
    def _bucket(n: int, cap: int) -> int:
        """Smallest power of two >= n (min 8), clamped to cap: the JAX
        package's padding, kept so both solve the same-sized system."""
        b = 8
        while b < n:
            b *= 2
        return min(b, cap)

    def to_device(self, device: torch.device | None = None) -> PoseGraph:
        """The padded graph tensors on `device` (default self.device)."""
        n, e, p = len(self.nodes), len(self.edges), len(self.priors)
        assert (n <= self.max_nodes and e <= self.max_edges
                and p <= self.max_priors)
        pn = self._bucket(n, self.max_nodes)
        pe = self._bucket(e, self.max_edges)
        pp = self._bucket(p, self.max_priors)
        eye = np.eye(4, dtype=np.float32)
        nodes = np.broadcast_to(eye, (pn, 4, 4)).copy()
        if n:
            nodes[:n] = np.stack(self.nodes)
        ei, ej = np.zeros(pe, np.int64), np.zeros(pe, np.int64)
        ez = np.broadcast_to(eye, (pe, 4, 4)).copy()
        ew = np.ones((pe, 6), np.float32)
        em, er = np.zeros(pe, bool), np.zeros(pe, bool)
        for k, (i, j, z, w, robust) in enumerate(self.edges):
            ei[k], ej[k], ez[k], ew[k], em[k], er[k] = i, j, z, w, True, robust
        pidx = np.zeros(pp, np.int64)
        pz = np.broadcast_to(eye, (pp, 4, 4)).copy()
        pw = np.ones((pp, 6), np.float32)
        pmask = np.zeros(pp, bool)
        for k, (i, z, w) in enumerate(self.priors):
            pidx[k], pz[k], pw[k], pmask[k] = i, z, w, True

        def t(a):
            return torch.from_numpy(a).to(device or self.device)

        return PoseGraph(
            nodes=t(nodes), node_mask=t(np.arange(pn) < n), edge_i=t(ei),
            edge_j=t(ej), edge_z=t(ez), edge_weight=t(ew), edge_mask=t(em),
            edge_robust=t(er), prior_idx=t(pidx), prior_z=t(pz),
            prior_weight=t(pw), prior_mask=t(pmask))

    def optimize(self, iterations: int | None = None) -> np.ndarray:
        """Solve and return the optimized node poses (n, 4, 4)."""
        n, nodes = self.optimize_async(iterations)
        return self.consume_optimized(n, nodes.cpu().numpy())

    def optimize_async(self, iterations: int | None = None):
        """Run the LM solve, dense or matrix-free CG by cfg.solver ("auto":
        CG past cfg.dense_max_nodes padded nodes); returns (n_nodes, node
        tensor on `device`). The SLAM pipeline reads it back at its next
        drain."""
        cfg = self.cfg
        kw = dict(damping=cfg.damping,
                  iterations=iterations or cfg.max_iterations,
                  robust_c=cfg.robust_c, gnc_start_c=cfg.gnc_start_c)
        padded = self._bucket(len(self.nodes), self.max_nodes)
        if cfg.solver == "cg" or (cfg.solver == "auto"
                                  and padded > cfg.dense_max_nodes):
            out = optimize_cg(self.to_device(self.cg_device),
                              cg_iters=cfg.cg_iters, **kw)
        else:
            out = optimize(self.to_device(), **kw)
        return len(self.nodes), out.nodes

    def consume_optimized(self, n: int, nodes_np: np.ndarray) -> np.ndarray:
        """Install a fetched result as the new estimates of the first `n`
        nodes (nodes added after the solve keep theirs)."""
        opt = np.asarray(nodes_np[:n])
        for i in range(n):
            self.nodes[i] = opt[i]
        return opt


def correct_keyframe_poses(kf_T: np.ndarray, kf_submap: np.ndarray,
                           submap_init_T: np.ndarray,
                           submap_opt_T: np.ndarray) -> np.ndarray:
    """correctPoses / transformFusion: keyframe pose = submap_opt @
    (submap_init^-1 @ kf_init)."""
    rel = np.einsum("nij,njk->nik", np.linalg.inv(submap_init_T[kf_submap]),
                    kf_T)
    return np.einsum("nij,njk->nik", submap_opt_T[kf_submap], rel)
