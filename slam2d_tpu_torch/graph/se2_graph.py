"""SE(2) pose-graph backend: Gauss-Newton with loop closure, port of
slam2d_tpu/graph/se2_graph.py.

Edge error e_ij = t2v(Z_ij^-1 (Xi^-1 Xj)). The graph has a static
capacity: node and edge arrays are [Kmax, ...] and [Emax, ...] with
validity masks, as in the JAX package. Per Gauss-Newton iteration:

- each edge's 3x3 Jacobians in closed form (the JAX package takes them
  from `jax.jacfwd` of the same error; they agree to float32 rounding);
- the dense [3K, 3K] normal matrix and [3K] gradient assembled with
  `index_put_(accumulate=True)` of the [E, 3, 3] blocks;
- node 0 anchored by a 1e8 prior block, Levenberg damping on the
  diagonal, an identity block on every inactive node slot, then
  `core/numerics.cholesky_f32` (LAPACK's float32 factor on the CPU, as
  the JAX package's; on CUDA the float64 factor rounded to float32, as
  cuSOLVER's float32 one is ~10x less accurate here) and
  `torch.cholesky_solve`.

Everything is float32. The 3x3 block products are elementwise multiplies
and sums, so TF32 never applies to them (the JAX package asks for
"highest" matmul precision for the same reason: reduced-precision
products make H indefinite). A factorization that fails gives NaN poses,
as the JAX package's does; nothing raises, and no value is read back to
the host inside `optimize`.

`HostGraph` builds the graph in numpy on the host (keyframe admission is
a host event) and copies it to the device once, when a solve runs.

`make_optimize_sharded(cfg, mesh)` splits the edge set over the ranks of
a mesh (parallel/mesh.py): each rank assembles H, b and chi2 from its own
slice of the edge slots, a psum adds them, and the dense solve runs on
every rank.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam2d_tpu_torch.config import GraphConfig
from slam2d_tpu_torch.core import se2
from slam2d_tpu_torch.core.numerics import cholesky_f32


class PoseGraph(NamedTuple):
    poses: torch.Tensor        # [K, 3] current node estimates
    node_mask: torch.Tensor    # [K] bool: node slot in use
    n_nodes: torch.Tensor      # 0-d int32
    edges_ij: torch.Tensor     # [E, 2] int32 (i, j) node indices
    edges_z: torch.Tensor      # [E, 3] measured relative pose i -> j
    edges_omega: torch.Tensor  # [E, 3, 3] information matrices
    edge_mask: torch.Tensor    # [E] bool
    n_edges: torch.Tensor      # 0-d int32


def graph_init(cfg: GraphConfig, device="cuda") -> PoseGraph:
    """An empty graph of cfg's capacity on `device`."""
    return HostGraph(cfg).to_device(device)


def _numpy(x, dtype):
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.array(x, dtype)


class HostGraph:
    """Host-side graph builder mirroring PoseGraph's layout in numpy:
    nodes and edges accumulate here, and `to_device` makes a PoseGraph
    with one copy an array when an optimizer runs."""

    def __init__(self, cfg: GraphConfig):
        K, E = cfg.max_nodes, cfg.max_edges
        self.poses = np.zeros((K, 3), np.float32)
        self.node_mask = np.zeros(K, bool)
        self.n_nodes = 0
        self.edges_ij = np.zeros((E, 2), np.int32)
        self.edges_z = np.zeros((E, 3), np.float32)
        self.edges_omega = np.zeros((E, 3, 3), np.float32)
        self.edge_mask = np.zeros(E, bool)
        self.n_edges = 0

    @classmethod
    def from_arrays(cls, cfg: GraphConfig, g) -> "HostGraph":
        """Restore from a PoseGraph-shaped tree of numpy arrays or tensors
        (a checkpoint's "graph"); the arrays are copied."""
        self = cls(cfg)
        self.poses = _numpy(g.poses, np.float32)
        self.node_mask = _numpy(g.node_mask, bool)
        self.n_nodes = int(g.n_nodes)
        self.edges_ij = _numpy(g.edges_ij, np.int32)
        self.edges_z = _numpy(g.edges_z, np.float32)
        self.edges_omega = _numpy(g.edges_omega, np.float32)
        self.edge_mask = _numpy(g.edge_mask, bool)
        self.n_edges = int(g.n_edges)
        return self

    def add_node(self, pose) -> int:
        k = self.n_nodes
        self.poses[k] = np.asarray(pose, np.float32)
        self.node_mask[k] = True
        self.n_nodes = k + 1
        return k

    def add_edge(self, i: int, j: int, z, omega) -> int:
        e = self.n_edges
        self.edges_ij[e] = (i, j)
        self.edges_z[e] = np.asarray(z, np.float32)
        self.edges_omega[e] = np.asarray(omega, np.float32)
        self.edge_mask[e] = True
        self.n_edges = e + 1
        return e

    def to_device(self, device="cuda") -> PoseGraph:
        """A PoseGraph on `device` holding copies of the arrays."""
        def t(a):
            return torch.tensor(a, device=device)

        return PoseGraph(
            poses=t(self.poses), node_mask=t(self.node_mask),
            n_nodes=torch.tensor(self.n_nodes, dtype=torch.int32,
                                 device=device),
            edges_ij=t(self.edges_ij), edges_z=t(self.edges_z),
            edges_omega=t(self.edges_omega), edge_mask=t(self.edge_mask),
            n_edges=torch.tensor(self.n_edges, dtype=torch.int32,
                                 device=device),
        )

    def set_poses(self, poses) -> None:
        """Write back optimizer-corrected node estimates (host copy)."""
        n = len(poses)
        self.poses[:n] = np.asarray(poses, np.float32)


def add_node(g: PoseGraph, pose) -> PoseGraph:
    """The graph with one more node (new tensors; `g` is unchanged). Reads
    the node count to the host."""
    k = int(g.n_nodes)
    poses, node_mask = g.poses.clone(), g.node_mask.clone()
    poses[k] = torch.as_tensor(pose, dtype=torch.float32, device=poses.device)
    node_mask[k] = True
    return g._replace(poses=poses, node_mask=node_mask, n_nodes=g.n_nodes + 1)


def add_edge(g: PoseGraph, i, j, z, omega) -> PoseGraph:
    """The graph with one more edge (new tensors; `g` is unchanged). Reads
    the edge count to the host."""
    e = int(g.n_edges)
    dev = g.poses.device
    ij, ez = g.edges_ij.clone(), g.edges_z.clone()
    eo, em = g.edges_omega.clone(), g.edge_mask.clone()
    ij[e] = torch.tensor([int(i), int(j)], dtype=torch.int32, device=dev)
    ez[e] = torch.as_tensor(z, dtype=torch.float32, device=dev)
    eo[e] = torch.as_tensor(omega, dtype=torch.float32, device=dev)
    em[e] = True
    return g._replace(edges_ij=ij, edges_z=ez, edges_omega=eo, edge_mask=em,
                      n_edges=g.n_edges + 1)


def _ends(poses, edges_ij):
    return poses[edges_ij[:, 0].long()], poses[edges_ij[:, 1].long()]


def edge_residuals(poses, edges_ij, edges_z):
    """e_ij = t2v(Z^-1 (Xi^-1 Xj)) of every edge slot; returns [E, 3]."""
    xi, xj = _ends(poses, edges_ij)
    return se2.error_se2(xi, xj, edges_z)


def _mm(a, b):
    """Batched 3x3 products [..., 3, 3] @ [..., 3, 3] as elementwise float32
    multiplies and sums (no TF32)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _mv(a, v):
    """Batched [..., 3, 3] @ [..., 3], elementwise."""
    return (a * v[..., None, :]).sum(-1)


def _quad(e, omega):
    """e^T Omega e of every edge: (e @ Omega) @ e."""
    return ((e[..., :, None] * omega).sum(-2) * e).sum(-1)


def _jacobians(xi, xj, z):
    """(d e / d xi, d e / d xj) [E, 3, 3] of error_se2 in closed form.

    With d = Xi^-1 Xj (translation d_t, rotation d_th), R(a) the rotation
    by a and M = R(z_th)^T R(xi_th)^T: d e_t / d t_j = M, d e_t / d t_i =
    -M, d e_t / d xi_th = R(z_th)^T (d_y, -d_x), d e_th / d th_j = 1 and
    d e_th / d th_i = -1."""
    ci, si = torch.cos(xi[:, 2]), torch.sin(xi[:, 2])
    cz, sz = torch.cos(z[:, 2]), torch.sin(z[:, 2])
    dx = xj[:, 0] - xi[:, 0]
    dy = xj[:, 1] - xi[:, 1]
    d_x = ci * dx + si * dy
    d_y = -si * dx + ci * dy
    m00 = cz * ci - sz * si
    m01 = cz * si + sz * ci
    m10 = -sz * ci - cz * si
    m11 = cz * ci - sz * si
    zero = torch.zeros_like(ci)
    one = torch.ones_like(ci)
    Bj = torch.stack([
        torch.stack([m00, m01, zero], -1),
        torch.stack([m10, m11, zero], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    Ai = torch.stack([
        torch.stack([-m00, -m01, cz * d_y - sz * d_x], -1),
        torch.stack([-m10, -m11, -sz * d_y - cz * d_x], -1),
        torch.stack([zero, zero, -one], -1),
    ], -2)
    return Ai, Bj


def _robust_weight(chi, kind: str, delta):
    """IRLS weight and robustified cost of each edge from chi2 = e^T Omega e.

    kind="huber": w = min(1, delta / ||e||), rho = delta (2||e|| - delta)
    past the threshold. kind="dcs": Dynamic Covariance Scaling with Phi =
    delta^2: s = min(1, 2 Phi / (Phi + chi2)), weight s^2, cost s chi2.
    `delta` is a host number (float32 where the JAX package's is a traced
    float32)."""
    if kind == "huber":
        d = float(delta)
        norm = torch.sqrt(torch.clamp(chi, min=1e-12))
        w = torch.clamp(torch.full_like(norm, d) / norm, max=1.0)
        rho = torch.where(norm <= d, chi, d * (2.0 * norm - d))
        return w, rho
    if kind == "dcs":
        phi = delta * delta
        s = torch.clamp(
            torch.full_like(chi, float(2.0 * phi)) / (chi + float(phi)),
            max=1.0,
        )
        return s * s, s * chi
    raise ValueError(f"unknown robust_kind {kind!r}")


def _edge_blocks(poses, edges_ij, edges_z, edges_omega, edge_mask,
                 robust: tuple | None = None):
    """Per-edge H and b blocks: (Hii, Hij, Hjj, bi, bj, chi2) stacked [E, ...].

    `robust=(kind, delta)` scales each edge's information by the robust
    kernel's weight of its whitened residual (IRLS, evaluated at the
    current poses); masked edge slots contribute zeros."""
    xi, xj = _ends(poses, edges_ij)
    e = se2.error_se2(xi, xj, edges_z)
    Ai, Bj = _jacobians(xi, xj, edges_z)
    m = edge_mask.to(torch.float32)
    w = m
    chi = _quad(e, edges_omega)
    if robust is not None:
        w_rob, chi = _robust_weight(chi, *robust)
        w = w * w_rob
    AtO = _mm(Ai.transpose(-1, -2), edges_omega) * w[:, None, None]
    BtO = _mm(Bj.transpose(-1, -2), edges_omega) * w[:, None, None]
    return (_mm(AtO, Ai), _mm(AtO, Bj), _mm(BtO, Bj), _mv(AtO, e),
            _mv(BtO, e), m * chi)


def _robust_of(cfg: GraphConfig, it: int | None = None):
    """(kind, effective delta) for Gauss-Newton iteration `it`, or None.

    With robust_gnc_iters > 0 the threshold anneals by 10x an iteration
    down to cfg.robust_delta (graduated non-convexity), computed in
    float32 as the JAX package computes it; `it=None` means fully
    robust."""
    if cfg.robust_kind == "none":
        return None
    delta = cfg.robust_delta
    if it is not None and cfg.robust_gnc_iters > 0:
        scale = np.float32(10.0) ** np.float32(
            max(0.0, float(np.float32(cfg.robust_gnc_iters) - it))
        )
        delta = np.float32(delta) * scale
    return cfg.robust_kind, delta


def assemble_normal_eq(poses, edges_ij, edges_z, edges_omega, edge_mask,
                       K: int, robust: tuple | None = None):
    """Dense H [3K, 3K], b [3K] and the summed chi2 (0-d), the blocks added
    with index_put_(accumulate=True) in the JAX package's order."""
    Hii, Hij, Hjj, bi, bj, chi = _edge_blocks(
        poses, edges_ij, edges_z, edges_omega, edge_mask, robust
    )
    dev = poses.device
    H = torch.zeros((3 * K, 3 * K), dtype=torch.float32, device=dev)
    b = torch.zeros(3 * K, dtype=torch.float32, device=dev)
    off = torch.arange(3, device=dev)
    ri = (3 * edges_ij[:, 0].long())[:, None] + off[None, :]   # [E, 3]
    rj = (3 * edges_ij[:, 1].long())[:, None] + off[None, :]

    def add(r, c, blk):
        H.index_put_(
            (r[:, :, None].expand_as(blk), c[:, None, :].expand_as(blk)),
            blk, accumulate=True,
        )

    add(ri, ri, Hii)
    add(ri, rj, Hij)
    add(rj, ri, Hij.transpose(1, 2))
    add(rj, rj, Hjj)
    b.index_put_((ri,), bi, accumulate=True)
    b.index_put_((rj,), bj, accumulate=True)
    return H, b, chi.sum()


def _gn_iterate(poses, H, b, node_mask, cfg: GraphConfig, K: int):
    """One damped Gauss-Newton solve and the masked update."""
    dev = poses.device
    diag = torch.zeros(3 * K, dtype=torch.float32, device=dev)
    diag[:3] = 1e8                                   # node 0's anchor
    # inactive node slots get an identity block so H stays invertible
    inactive = (~node_mask).repeat_interleave(3).to(torch.float32)
    diag = diag + cfg.damping + inactive
    # symmetrize: the scatter's float rounding leaves H asymmetric by a
    # few ulp, and Cholesky assumes exact symmetry
    Hd = 0.5 * (H + H.T) + torch.diag(diag)
    L, info = cholesky_f32(Hd)
    # a failed factorization is all NaN, as the JAX package's
    L = torch.where(info == 0, L, torch.full_like(L, torch.nan))
    delta = torch.cholesky_solve((-b)[:, None], L)[:, 0]
    delta = delta.reshape(K, 3) * node_mask[:, None]
    new = poses + delta
    return torch.cat([new[:, :2], se2.wrap_angle(new[:, 2:3])], dim=1)


def edge_chi2s(poses, g: PoseGraph):
    """Per-edge whitened residual^2 e^T Omega e at `poses` (masked edges
    report 0): the post-solve consistency statistic of the loop prune."""
    e = edge_residuals(poses, g.edges_ij, g.edges_z)
    return g.edge_mask.to(torch.float32) * _quad(e, g.edges_omega)


def optimize(g: PoseGraph, cfg: GraphConfig):
    """Run cfg.gn_iters Gauss-Newton iterations on the graph's device;
    returns (graph with the new poses, chi2 of the last linearization as
    a 0-d tensor). Reads nothing back to the host."""
    K = g.poses.shape[0]
    poses = g.poses
    chi = torch.zeros((), dtype=torch.float32, device=poses.device)
    for it in range(cfg.gn_iters):
        H, b, chi = assemble_normal_eq(
            poses, g.edges_ij, g.edges_z, g.edges_omega, g.edge_mask, K,
            _robust_of(cfg, it),
        )
        poses = _gn_iterate(poses, H, b, g.node_mask, cfg, K)
    return g._replace(poses=poses), chi


def make_optimize_sharded(cfg: GraphConfig, mesh):
    """Edge-sharded Gauss-Newton, the JAX package's make_optimize_sharded:
    returns run(g) -> (graph, chi2). Rank r assembles (H, b, chi2) from
    edge slots [r * E / n, (r + 1) * E / n) (max_edges must divide over
    the n ranks), the three are summed over the ranks by psum, and the
    damped solve runs replicated. Every rank passes the same graph and
    gets the same poses."""
    n, r = mesh.world_size, mesh.rank

    def run(g: PoseGraph):
        E = g.edges_ij.shape[0]
        if E % n:
            raise ValueError(f"max_edges={E} must divide {n} shards")
        lo, hi = r * E // n, (r + 1) * E // n
        K = g.poses.shape[0]
        poses = g.poses
        chi = torch.zeros((), dtype=torch.float32, device=poses.device)
        for it in range(cfg.gn_iters):
            H, b, chi = assemble_normal_eq(
                poses, g.edges_ij[lo:hi], g.edges_z[lo:hi],
                g.edges_omega[lo:hi], g.edge_mask[lo:hi], K,
                _robust_of(cfg, it),
            )
            H, b, chi = mesh.psum(H), mesh.psum(b), mesh.psum(chi)
            poses = _gn_iterate(poses, H, b, g.node_mask, cfg, K)
        return g._replace(poses=poses), chi

    return run
