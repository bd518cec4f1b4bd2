"""Matrix-free SE(2) pose-graph Gauss-Newton for large graphs, port of
slam2d_tpu/graph/sparse.py.

No [3K, 3K] object is made: the odometry chain and every diagonal block
form a block-tridiagonal SPD matrix T, factored once a Gauss-Newton
iteration by the block-Thomas recurrence (kernel `tridiag_factor`,
ops/tridiag.py) and applied by two affine prefix scans; the loop edges
stay edge-resident.

- `optimize_cg`: each Gauss-Newton step solves H delta = -b by a fixed
  number of preconditioned CG iterations. H applies matrix-free (a
  gather at the edges' endpoints, batched 3x3 products, segment sums
  back); the preconditioner is additive two-level, T^-1 plus W Hc^-1
  W^T with W spanning chain-linear interpolation over
  `sparse_coarse_stride`-spaced anchors and the 6 coordinates of each
  loop edge's endpoints (Hc a small dense Cholesky).
- `optimize_hier`: the recursive V-cycle: the anchor graph (chain
  measurements composed between anchors by a segmented prefix scan over
  SE(2), loop edges re-anchored) solved down to `hier_dense_max` nodes
  by the dense solver (graph/se2_graph.py; `_coarse_optimize` adds a
  fallback where its anchored factor fails), the correction prolonged
  rigidly over each segment, then `optimize_cg` as the polish;
  `sparse_hier_cycles` cycles. As in the JAX package the recursion runs
  on the graph's capacity (K = poses.shape[0]), not its live nodes.
- Gauge: node 0 and inactive slots are clamped by projection (identity
  rows, zero couplings and gradient), not by a prior: the f32 Thomas
  solve loses half its digits at the prior's condition.

The graph's topology is fixed within a call, so everything that depends
only on it (the segment sums' routing, the loop slots, the coarse
graphs' edge lists) is worked out once a call on the host, in numpy
(`sparse_plan`, from a HostGraph or read back from a PoseGraph), and
copied to the device: each segment sum then gathers its sources through
a padded [N, M] table and sums each row (a fixed order; no sort and no
atomics, unlike `index_put_(accumulate=True)`). The two associative
scans run as log-depth doubling (ceil(log2 K) rounds of batched 3x3
products), another tree than JAX's `associative_scan`, so their sums
round differently. Everything is float32 with TF32 off ("highest"
matmul precision, as the JAX package asks for). Nothing is read back to
the host during a solve; a failed factorization gives NaN.

`optimize_cg_sharded` splits the edge set over the ranks of a mesh
(parallel/mesh.py): each rank assembles D, O, b and chi2 and applies H
from its own edge slice, and psum adds them; the preconditioner's loop
edges are the first `sparse_max_loops` valid ones of every rank's
candidates, all-gathered, so that it is the same on every rank; the
factor and the PCG vectors are replicated.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from slam2d_tpu_torch.config import GraphConfig
from slam2d_tpu_torch.core import se2
from slam2d_tpu_torch.core.numerics import highest_matmul_precision
from slam2d_tpu_torch.graph import se2_graph
from slam2d_tpu_torch.graph.schur import _cho_solve, _cholesky
from slam2d_tpu_torch.graph.se2_graph import PoseGraph, _edge_blocks, _robust_of
from slam2d_tpu_torch.ops.tridiag import tridiag_factor


# ---------------------------------------------------------------------------
# host plan: the topology of every level, worked out once a call

def _table(dest: np.ndarray, n_out: int) -> np.ndarray:
    """[n_out, M] int64: row k lists, in source order, the sources s with
    dest[s] == k, padded with len(dest) (the index of a zero row)."""
    n_src = len(dest)
    order = np.argsort(dest, kind="stable")
    counts = np.bincount(dest, minlength=n_out)[:n_out]
    M = max(int(counts.max()) if n_out else 1, 1)
    table = np.full((n_out, M), n_src, np.int64)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    d = dest[order]
    rank = np.arange(n_src) - first[d]
    table[d, rank] = order
    return table


def _loop_slots_np(edges_ij, edge_mask, Lmax: int):
    """The first Lmax loop (non-chain) edge slots in insertion order:
    (idx [min(Lmax, E)], valid), as the JAX package's _loop_slots sorts
    them."""
    ei, ej = edges_ij[:, 0].astype(np.int64), edges_ij[:, 1].astype(np.int64)
    is_loop = edge_mask & (np.abs(ei - ej) != 1)
    E = len(ei)
    order = np.argsort(np.where(is_loop, 0, 1) * (E + 1) + np.arange(E),
                       kind="stable")
    idx = order[:Lmax]
    return idx, is_loop[idx]


class _Level(NamedTuple):
    """One level's routing on the device."""

    K: int
    seg_i: torch.Tensor      # [K, Mi] edges by endpoint i (n_edges sources)
    seg_j: torch.Tensor      # [K, Mj] edges by endpoint j
    n_src: int               # edges routed (slots past it are masked)
    loop_idx: torch.Tensor   # [L] int64 loop-edge slots
    node_of: torch.Tensor    # [6L] int64 endpoint node of each U column
    coord_of: torch.Tensor   # [6L] int64 its coordinate
    uvalid: torch.Tensor     # [6L] float32
    u_table: torch.Tensor    # [3K, Mu] U columns by flat (node, coord)
    a0: torch.Tensor         # [K] int64 left anchor of each node
    a1: torch.Tensor         # [K] right anchor
    w0: torch.Tensor         # [K] float32 hat weights
    w1: torch.Tensor
    r0: torch.Tensor         # [Kc, M] nodes by left anchor
    r1: torch.Tensor         # [Kc, M] nodes by right anchor
    Kc: int
    coarse: "_Coarse | None"  # the next level's edge list, when it exists


class _Coarse(NamedTuple):
    """The host-side edge list of a level's anchor graph."""

    edges_ij: torch.Tensor   # [Ec, 2] int32
    edge_mask: torch.Tensor  # [Ec] bool
    n_nodes: int
    anchors: torch.Tensor    # [Kc] int64 anchor node of each coarse node
    seg_of: torch.Tensor     # [K] int64 segment of each node
    last: torch.Tensor       # [Kc - 1] int64 last node of each segment


class SparsePlan(NamedTuple):
    """sparse_plan's levels, finest first: for optimize_hier down to the
    first whose capacity is at most hier_dense_max (solved dense), each
    with its anchor graph's edge list; for optimize_cg the finest alone."""

    levels: tuple


def _coarse_basis_np(K: int, Kc: int, stride: int):
    kk = np.arange(K)
    a0 = np.minimum(kk // stride, Kc - 1)
    a1 = np.minimum(a0 + 1, Kc - 1)
    w1 = np.where(a1 > a0, (kk % stride).astype(np.float32)
                  / np.float32(stride), np.float32(0.0)).astype(np.float32)
    return a0, a1, (np.float32(1.0) - w1).astype(np.float32), w1


def _level(edges_ij, edge_mask, n_edges: int, n_nodes: int, K: int,
           cfg: GraphConfig, with_coarse: bool, device, loops=None):
    """One level's routing from its host edge list (numpy), and, with
    `with_coarse`, its anchor graph's edge list and node count. `loops`
    = (li, lj, valid) gives the preconditioner's loop edges by their
    endpoints instead of the first loop slots of this edge list."""
    stride = cfg.sparse_coarse_stride
    Kc = max(2, -(-K // stride))
    ei = edges_ij[:n_edges, 0].astype(np.int64)
    ej = edges_ij[:n_edges, 1].astype(np.int64)
    idx, valid = _loop_slots_np(edges_ij, edge_mask, cfg.sparse_max_loops)
    li = edges_ij[idx, 0].astype(np.int64)
    lj = edges_ij[idx, 1].astype(np.int64)
    if loops is not None:
        li, lj, valid = loops
    L = len(li)
    node_of = np.repeat(np.concatenate([li, lj]), 3)
    coord_of = np.tile(np.arange(3), 2 * L)
    uvalid = np.repeat(np.concatenate([valid, valid]), 3).astype(np.float32)
    a0, a1, w0, w1 = _coarse_basis_np(K, Kc, stride)

    def t(a):
        return torch.as_tensor(a, device=device)

    coarse = None
    if with_coarse:
        ca, cb = li // stride, lj // stride
        cvalid = valid & (ca != cb)
        nc = min((n_nodes + stride - 1) // stride, Kc)
        cij = np.stack([np.arange(Kc - 1), np.arange(1, Kc)], 1)
        coarse = _Coarse(
            edges_ij=t(np.concatenate([cij, np.stack([ca, cb], 1)])
                       .astype(np.int32)),
            edge_mask=t(np.concatenate([np.arange(Kc - 1) < nc - 1, cvalid])),
            n_nodes=nc,
            anchors=t(np.minimum(np.arange(Kc) * stride, K - 1)),
            seg_of=t(np.minimum(np.arange(K) // stride, Kc - 1)),
            last=t(np.minimum((np.arange(Kc - 1) + 1) * stride - 1, K - 2)),
        )
    lv = _Level(
        K=K, seg_i=t(_table(ei, K)), seg_j=t(_table(ej, K)), n_src=n_edges,
        loop_idx=t(idx.astype(np.int64)),
        node_of=t(node_of), coord_of=t(coord_of), uvalid=t(uvalid),
        u_table=t(_table(3 * node_of + coord_of, 3 * K)),
        a0=t(a0), a1=t(a1), w0=t(w0), w1=t(w1),
        r0=t(_table(a0, Kc)), r1=t(_table(a1, Kc)), Kc=Kc, coarse=coarse,
    )
    return lv


def _host_graph_arrays(g):
    """(edges_ij, edge_mask, n_nodes, n_edges) on the host from a
    HostGraph (no device read) or a PoseGraph (one read each)."""
    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    return (host(g.edges_ij), host(g.edge_mask).astype(bool),
            int(host(g.n_nodes)), int(host(g.n_edges)))


def sparse_plan(g, cfg: GraphConfig, device, hier: bool) -> SparsePlan:
    """The routing of every level a solve of `g` runs on `device`: the
    finest level alone for `optimize_cg` (`hier=False`), and for
    `optimize_hier` the anchor graphs down to hier_dense_max nodes. `g` is
    a HostGraph (numpy; nothing is read from a device) or a PoseGraph
    (its edge list, mask and counts are read to the host). Pass it back
    as `plan=` to solve a graph of the same topology again."""
    edges_ij, edge_mask, n_nodes, n_edges = _host_graph_arrays(g)
    K = g.poses.shape[0]
    dense_max = int(cfg.hier_dense_max)
    levels = []
    while True:
        lv = _level(edges_ij, edge_mask, n_edges, n_nodes, K, cfg, hier,
                    device)
        levels.append(lv)
        if not (hier and K > dense_max):
            break
        c = lv.coarse
        edges_ij = c.edges_ij.cpu().numpy()
        edge_mask = c.edge_mask.cpu().numpy()
        n_nodes, n_edges, K = c.n_nodes, len(edges_ij), lv.Kc
    return SparsePlan(levels=tuple(levels))


# ---------------------------------------------------------------------------
# the solver

def _seg(x, table):
    """Segment sum through a routing table: out[k] = sum of x[table[k, :]]
    (x's rows past its length read as zeros)."""
    xp = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    return xp[table].sum(1)


def _assemble_sparse(poses, g: PoseGraph, robust, damping: float,
                     lv: _Level, mesh=None):
    """(D, O, b, chi, free, (Hii, Hij, Hjj)) of the JAX package's
    `_assemble_sparse`: D [K, 3, 3] the diagonal blocks (every edge's Hii,
    Hjj) + damping, O [K, 3, 3] the chain off-diagonals (O[k] the block
    (k, k+1)), b [K, 3], all projected (clamped nodes: identity diagonal,
    zero couplings and gradient); free [K] float32 is 1 on the nodes the
    solve may move (active, k > 0). The per-edge blocks are those of the
    routed edges (the slots before n_edges). With a `mesh`, D, O, b and
    chi2 are summed over the ranks before the projection."""
    K = poses.shape[0]
    n = lv.n_src
    ij = g.edges_ij[:n]
    Hii, Hij, Hjj, bi, bj, chi = _edge_blocks(
        poses, ij, g.edges_z[:n], g.edges_omega[:n], g.edge_mask[:n], robust)
    ei, ej = ij[:, 0], ij[:, 1]
    dev = poses.device
    free = (g.node_mask & (torch.arange(K, device=dev) > 0)).to(torch.float32)
    D = _seg(Hii, lv.seg_i) + _seg(Hjj, lv.seg_j)
    fwd = (ej == ei + 1).to(torch.float32)[:, None, None]
    rev = (ei == ej + 1).to(torch.float32)[:, None, None]
    O = _seg(Hij * fwd, lv.seg_i) + _seg(Hij.transpose(1, 2) * rev, lv.seg_j)
    b = _seg(bi, lv.seg_i) + _seg(bj, lv.seg_j)
    chi = chi.sum()
    if mesh is not None:
        D, O, b, chi = (mesh.psum(x) for x in (D, O, b, chi))
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    f3 = free[:, None, None]
    D = f3 * (D + damping * eye) + (1.0 - f3) * eye
    free_pair = torch.cat([free[:-1] * free[1:], free.new_zeros(1)])
    O = O * free_pair[:, None, None]
    b = b * free[:, None]
    return D, O, b, chi, free, (Hii, Hij, Hjj)


def _affine_scan(A, C):
    """X[k] = A[k] X[k-1] + C[k] (X[-1] = 0) for every k, A [K, 3, 3],
    C [K, 3, N]: the prefix composition of the affine maps by doubling
    (round s composes each map with the one 2^s before it)."""
    K = A.shape[0]
    s = 1
    while s < K:
        A, C = (torch.cat([A[:s], A[s:] @ A[:-s]]),
                torch.cat([C[:s], A[s:] @ C[:-s] + C[s:]]))
        s *= 2
    return C


def _tridiag_apply_multi(Cinv, O, R):
    """Solve T X = R (R [K, 3, N]) with the Thomas factors: forward then
    back substitution, both affine scans."""
    z1 = Cinv.new_zeros((1, 3, 3))
    O_prev = torch.cat([z1, O[:-1]])
    C_prev = torch.cat([z1, Cinv[:-1]])
    OtC = O_prev.transpose(1, 2) @ C_prev
    y = _affine_scan(-OtC, R)
    Cy = Cinv @ y
    CO = Cinv @ O
    x_rev = _affine_scan(-CO.flip(0), Cy.flip(0))
    return x_rev.flip(0)


def _tridiag_apply(Cinv, O, r):
    """Solve T x = r for one [K, 3] right-hand side."""
    return _tridiag_apply_multi(Cinv, O, r[..., None])[..., 0]


def _make_matvec(g: PoseGraph, Hii, Hij, Hjj, free, damping: float,
                 lv: _Level, mesh=None):
    """Matrix-free projected H V for V [K, 3] or [K, 3, N]: clamped nodes
    act as identity rows. With a `mesh` the edges' products are summed
    over the ranks."""
    n = lv.n_src
    ei = g.edges_ij[:n, 0].to(torch.int64)
    ej = g.edges_ij[:n, 1].to(torch.int64)
    HijT = Hij.transpose(1, 2)

    def matvec(v):
        single = v.dim() == 2
        V = v[..., None] if single else v
        fm = free[:, None, None]
        vm = V * fm
        vi, vj = vm[ei], vm[ej]
        yi = Hii @ vi + Hij @ vj
        yj = HijT @ vi + Hjj @ vj
        y = _seg(yi, lv.seg_i) + _seg(yj, lv.seg_j)
        if mesh is not None:
            y = mesh.psum(y)
        y = (y + damping * vm) * fm
        y = y + (1.0 - fm) * V
        return y[..., 0] if single else y

    return matvec


def _prolong(vc, lv: _Level):
    """[Kc, 3, N] coarse deltas -> [K, 3, N] by the hat functions."""
    return (vc[lv.a0] * lv.w0[:, None, None]
            + vc[lv.a1] * lv.w1[:, None, None])


def _restrict(v, lv: _Level):
    """The transpose of `_prolong`: [K, 3, N] -> [Kc, 3, N]."""
    return (_seg(v * lv.w0[:, None, None], lv.r0)
            + _seg(v * lv.w1[:, None, None], lv.r1))


def _make_two_level(g: PoseGraph, Cinv, O, matvec, free, lv: _Level):
    """The additive two-level preconditioner M^-1 = T^-1 + W Hc^-1 W^T of
    the JAX package's `_make_two_level`: W = [P | U] (P the hat functions
    over the anchors, U the loop endpoints' coordinates), Hc = W^T H W
    (dense [3Kc + 6L]^2, jittered) Cholesky-factored once."""
    K, Kc = lv.K, lv.Kc
    dev = Cinv.device
    nP = 3 * Kc
    nU = lv.node_of.shape[0]
    n = nP + nU
    f1 = free[:, None]

    def w_apply(c):                                   # [n] -> [K, 3]
        fine = _prolong(c[:nP].reshape(Kc, 3, 1), lv)[..., 0]
        u = _seg(c[nP:] * lv.uvalid, lv.u_table).reshape(K, 3)
        return (fine + u) * f1

    def wT_apply(v):                                  # [K, 3] -> [n]
        vm = v * f1
        cP = _restrict(vm[:, :, None], lv)[..., 0].reshape(-1)
        cU = vm[lv.node_of, lv.coord_of] * lv.uvalid
        return torch.cat([cP, cU])

    eyeP = torch.eye(nP, dtype=torch.float32, device=dev).reshape(Kc, 3, nP)
    WP = _prolong(eyeP, lv)                           # [K, 3, nP]
    WU = torch.zeros((K, 3, nU), dtype=torch.float32, device=dev)
    WU[lv.node_of, lv.coord_of, torch.arange(nU, device=dev)] = lv.uvalid
    W = torch.cat([WP, WU], dim=-1) * free[:, None, None]
    HW = matvec(W)                                    # [K, 3, n]
    Hc_top = _restrict(HW, lv).reshape(nP, n)
    Hc_bot = HW[lv.node_of, lv.coord_of, :] * lv.uvalid[:, None]
    Hc = torch.cat([Hc_top, Hc_bot], dim=0)
    Hc = 0.5 * (Hc + Hc.T)
    dg = torch.diagonal(Hc)
    jit_scale = 1e-5 * torch.clamp_min(dg.max(), 1.0)
    Hc = Hc + torch.diag(jit_scale + 1.0 * (dg <= 0.0).to(torch.float32))
    L = _cholesky(Hc)

    def precond(r):
        t = _tridiag_apply(Cinv, O, r)
        zc = _cho_solve(L, wT_apply(r)[:, None])[:, 0]
        return t + w_apply(zc)

    return precond


def _pcg(matvec, precond, b, iters: int):
    """Fixed-iteration preconditioned CG for H x = b from x = 0; a zero or
    converged residual makes every later iteration a no-op (alpha and
    beta guarded on the device). Returns (x, |r|)."""
    def dot(a, c):
        return (a * c).sum()

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = dot(r, z)
    for _ in range(iters):
        Hp = matvec(p)
        denom = dot(p, Hp)
        alpha = torch.where(denom > 0.0, rz / torch.clamp_min(denom, 1e-30),
                            0.0)
        x = x + alpha * p
        r = r - alpha * Hp
        z = precond(r)
        rz_new = dot(r, z)
        beta = torch.where(rz > 0.0, rz_new / torch.clamp_min(rz, 1e-30), 0.0)
        p = z + beta * p
        rz = rz_new
    return x, torch.sqrt(dot(r, r))


def _optimize_cg_level(g: PoseGraph, cfg: GraphConfig, lv: _Level,
                       mesh=None):
    poses = g.poses
    chi = torch.zeros((), dtype=torch.float32, device=poses.device)
    for it in range(cfg.gn_iters):
        D, O, b, chi, free, (Hii, Hij, Hjj) = _assemble_sparse(
            poses, g, _robust_of(cfg, it), cfg.damping, lv, mesh)
        Cinv = tridiag_factor(D, O)
        matvec = _make_matvec(g, Hii, Hij, Hjj, free, cfg.damping, lv,
                              mesh)
        precond = _make_two_level(g, Cinv, O, matvec, free, lv)
        delta, _ = _pcg(matvec, precond, -b, cfg.sparse_cg_iters)
        new = poses + delta * free[:, None]
        poses = torch.cat([new[:, :2], se2.wrap_angle(new[:, 2:3])], dim=1)
    return g._replace(poses=poses), chi


def optimize_cg(g: PoseGraph, cfg: GraphConfig, plan: SparsePlan | None = None):
    """cfg.gn_iters Gauss-Newton iterations, each solved by
    cfg.sparse_cg_iters two-level preconditioned CG iterations (module
    docstring); returns (graph with the new poses, chi2 of the last
    linearization as a 0-d tensor), as se2_graph.optimize does. `plan` is
    sparse_plan(..., hier=False) of the same graph (built here from `g`
    when not given, which reads its edge list back)."""
    if plan is None:
        plan = sparse_plan(g, cfg, g.poses.device, hier=False)
    with highest_matmul_precision():
        return _optimize_cg_level(g, cfg, plan.levels[0])


def _segmented_compose(z_chain, K: int, stride: int):
    """R[k] = z_a ⊕ ... ⊕ z_{k-1} for a = stride * (k // stride) (the
    identity at anchors): a segmented prefix scan over SE(2) composition,
    elements (pose, reset) combined as (p2 if r2 else p1 ⊕ p2, r1 | r2),
    by doubling. z_chain[k] is the measured delta k -> k + 1."""
    dev = z_chain.device
    idx = torch.arange(K, device=dev)
    reset = (idx % stride == 0) | (idx == 0)
    z_prev = torch.cat([z_chain.new_zeros((1, 3)), z_chain[:-1]])
    p = torch.where(reset[:, None], 0.0, z_prev)
    s = 1
    while s < K:
        p_new, r_new = p.clone(), reset.clone()
        comb = se2.compose(p[:-s], p[s:])
        p_new[s:] = torch.where(reset[s:, None], p[s:], comb)
        r_new[s:] = reset[:-s] | reset[s:]
        p, reset = p_new, r_new
        s *= 2
    return p


def _coarse_graph(g: PoseGraph, cfg: GraphConfig, lv: _Level):
    """The anchor-subsampled graph of the JAX package's `_coarse_graph`:
    every stride-th node, chain edges carrying the composed odometry
    between anchors (information scaled 1/stride), loop edges
    re-anchored by the measured intra-segment transforms. Returns
    (coarse PoseGraph, coarse cfg)."""
    stride = cfg.sparse_coarse_stride
    K, Kc, c = lv.K, lv.Kc, lv.coarse
    dev = g.poses.device
    n = lv.n_src
    ij = g.edges_ij[:n]
    ei, ej = ij[:, 0], ij[:, 1]
    em = g.edge_mask[:n]
    z = g.edges_z[:n]
    chain_f = (ej == ei + 1) & em
    chain_r = (ei == ej + 1) & em
    zf = torch.where(chain_f[:, None], z, 0.0)
    zr = torch.where(chain_r[:, None], se2.inverse(z), 0.0)
    z_chain = _seg(zf, lv.seg_i) + _seg(zr, lv.seg_j)
    have = (_seg(chain_f.to(torch.float32), lv.seg_i)
            + _seg(chain_r.to(torch.float32), lv.seg_j))
    z_chain = z_chain / torch.clamp_min(have[:, None], 1.0)
    R = _segmented_compose(z_chain, K, stride)

    zc_chain = se2.compose(R[c.last], z_chain[c.last])
    cf = chain_f.to(torch.float32)
    om_mean = (g.edges_omega[:n] * cf[:, None, None]).sum(0) / torch.clamp_min(
        cf.sum(), 1.0)
    omc_chain = (om_mean / stride).expand(Kc - 1, 3, 3)

    idx = lv.loop_idx
    li = g.edges_ij[idx, 0].to(torch.int64)
    lj = g.edges_ij[idx, 1].to(torch.int64)
    z_l = se2.compose(se2.compose(R[li], g.edges_z[idx]), se2.inverse(R[lj]))
    gc = PoseGraph(
        poses=g.poses[c.anchors], node_mask=g.node_mask[c.anchors],
        n_nodes=torch.tensor(c.n_nodes, dtype=torch.int32, device=dev),
        edges_ij=c.edges_ij, edges_z=torch.cat([zc_chain, z_l]),
        edges_omega=torch.cat([omc_chain, g.edges_omega[idx]]),
        edge_mask=c.edge_mask,
        n_edges=torch.tensor(c.edges_ij.shape[0], dtype=torch.int32,
                             device=dev),
    )
    ccfg = dataclasses.replace(cfg, max_nodes=Kc,
                               max_edges=c.edges_ij.shape[0])
    return gc, ccfg


def _coarse_iterate(poses, H, b, node_mask, cfg: GraphConfig, K: int):
    """se2_graph._gn_iterate with one departure from the JAX package:
    where the anchored factor fails (its 1e8 prior on node 0 can push the
    condition of a float32 H past what the factor survives), the system
    is solved with node 0's three unknowns eliminated instead, the limit
    of that prior: Hd[3:, 3:] factored and node 0's step 0. The two are
    selected on the device; where the anchored factor succeeds the step
    is se2_graph._gn_iterate's to the bit on the CPU. On CUDA both factors
    stay cuSOLVER's float32 ones (_gn_iterate takes a float64 factor
    rounded to float32, core/numerics.cholesky_f32): the V-cycle's error
    on the card is the JAX package's over ulp-moved serpentines
    (chip_smoke.py phase 24 (b))."""
    dev = poses.device
    diag = torch.zeros(3 * K, dtype=torch.float32, device=dev)
    diag[:3] = 1e8                                   # node 0's anchor
    inactive = (~node_mask).repeat_interleave(3).to(torch.float32)
    diag = diag + cfg.damping + inactive
    Hd = 0.5 * (H + H.T) + torch.diag(diag)
    L, info = torch.linalg.cholesky_ex(Hd)
    L = torch.where(info == 0, L, torch.full_like(L, torch.nan))
    delta = torch.cholesky_solve((-b)[:, None], L)[:, 0]
    L0, info0 = torch.linalg.cholesky_ex(Hd[3:, 3:])
    L0 = torch.where(info0 == 0, L0, torch.full_like(L0, torch.nan))
    d0 = torch.cholesky_solve((-b[3:])[:, None], L0)[:, 0]
    delta = torch.where(info == 0, delta, torch.cat([d0.new_zeros(3), d0]))
    delta = delta.reshape(K, 3) * node_mask[:, None]
    new = poses + delta
    return torch.cat([new[:, :2], se2.wrap_angle(new[:, 2:3])], dim=1)


def _coarse_optimize(g: PoseGraph, cfg: GraphConfig):
    """The hierarchy's dense level: se2_graph.optimize with
    `_coarse_iterate`'s step. Full SLAM's dense solve stays
    se2_graph.optimize, without the second factor."""
    K = g.poses.shape[0]
    poses = g.poses
    chi = torch.zeros((), dtype=torch.float32, device=poses.device)
    for it in range(cfg.gn_iters):
        H, b, chi = se2_graph.assemble_normal_eq(
            poses, g.edges_ij, g.edges_z, g.edges_omega, g.edge_mask, K,
            _robust_of(cfg, it),
        )
        poses = _coarse_iterate(poses, H, b, g.node_mask, cfg, K)
    return g._replace(poses=poses), chi


def optimize_hier(g: PoseGraph, cfg: GraphConfig,
                  plan: SparsePlan | None = None):
    """Hierarchical Gauss-Newton for large graphs (module docstring): the
    V-cycle down to hier_dense_max nodes, the dense solve at the bottom,
    the rigid prolongation, `optimize_cg`'s polish at the top level;
    cfg.sparse_hier_cycles cycles. Returns (graph, chi2 0-d tensor).
    `plan` is sparse_plan(..., hier=True) of the same graph and config
    (built here from `g` when not given). Each level's solves are counted in
    `optimize_hier.stages` ("dense", "vcycle", "polish")."""
    if plan is None:
        plan = sparse_plan(g, cfg, g.poses.device, hier=True)
    levels = plan.levels
    cycles = max(1, int(cfg.sparse_hier_cycles))

    dense_max = int(cfg.hier_dense_max)

    def vcycle(g_l, cfg_l, depth: int, top: bool):
        lv = levels[depth]
        if lv.K <= dense_max:
            optimize_hier.stages["dense"] += 1
            return _coarse_optimize(g_l, cfg_l)
        optimize_hier.stages["vcycle"] += 1
        gc, ccfg = _coarse_graph(g_l, cfg_l, lv)
        gc2, chi_c = vcycle(gc, ccfg, depth + 1, top=False)
        # each segment moved rigidly by its anchor's correction X'_a ⊕ X_a^-1
        corr = se2.compose(gc2.poses, se2.inverse(g_l.poses[lv.coarse.anchors]))
        poses1 = se2.compose(corr[lv.coarse.seg_of], g_l.poses)
        g1 = g_l._replace(poses=poses1)
        if not top:
            return g1, chi_c
        optimize_hier.stages["polish"] += 1
        return _optimize_cg_level(g1, cfg_l, lv)

    with highest_matmul_precision():
        out, chi = vcycle(g, cfg, 0, top=True)
        for _ in range(cycles - 1):
            out, chi = vcycle(out, cfg, 0, top=True)
    return out, chi


optimize_hier.stages = {"dense": 0, "vcycle": 0, "polish": 0}


def sharded_cg_plan(g, cfg: GraphConfig, mesh) -> tuple:
    """(this rank's edge slice (lo, hi) of the padded edge capacity, its
    SparsePlan): the level routed over the slice's slots, the
    preconditioner's loop edges the first sparse_max_loops valid of every
    rank's candidates (each rank's first loop slots of its slice, one
    all_gather), as the JAX package keeps them. `g` is a HostGraph or a
    PoseGraph (its edge list is read back), the same on every rank."""
    edges_ij, edge_mask, n_nodes, _ = _host_graph_arrays(g)
    n = mesh.world_size
    E = len(edges_ij)
    El = -(-E // n)
    lo = mesh.rank * El
    ij = np.zeros((El, 2), np.int32)
    m = np.zeros(El, bool)
    take = max(0, min(E, lo + El) - lo)
    ij[:take] = edges_ij[lo : lo + take]
    m[:take] = edge_mask[lo : lo + take]
    idx, valid = _loop_slots_np(ij, m, cfg.sparse_max_loops)
    cand = np.stack([ij[idx, 0], ij[idx, 1], valid], 1).astype(np.int64)
    every = mesh.all_gather(torch.as_tensor(cand, device=mesh.device),
                            tiled=True).cpu().numpy()
    M = len(every)
    order = np.argsort(np.where(every[:, 2] > 0, 0, 1) * (M + 1)
                       + np.arange(M), kind="stable")[: cfg.sparse_max_loops]
    loops = (every[order, 0], every[order, 1], every[order, 2] > 0)
    lv = _level(ij, m, El, n_nodes, g.poses.shape[0], cfg, False,
                mesh.device, loops=loops)
    return (lo, lo + take, El), SparsePlan(levels=(lv,))


def optimize_cg_sharded(g: PoseGraph, cfg: GraphConfig, mesh,
                        plan: tuple | None = None):
    """optimize_cg with the EDGE set split over the ranks of `mesh`, the
    JAX package's optimize_cg_sharded: the edge capacity padded to a
    multiple of the world size with masked slots, rank r assembling and
    applying H from its slice, psum reducing (module docstring). Every
    rank passes the same graph (and `plan`, sharded_cg_plan of it, built
    here when not given) and gets the same poses; returns (graph with the
    caller's edge capacity, chi2). The sums' order differs from
    optimize_cg's, so the two agree to rounding."""
    if plan is None:
        plan = sharded_cg_plan(g, cfg, mesh)
    (lo, hi, El), sp = plan
    dev = g.poses.device

    def part(x, fill_shape):
        x = x[lo:hi]
        pad = El - x.shape[0]
        if pad:
            x = torch.cat([x, torch.zeros((pad,) + fill_shape,
                                          dtype=x.dtype, device=dev)])
        return x

    g_l = g._replace(
        edges_ij=part(g.edges_ij, (2,)), edges_z=part(g.edges_z, (3,)),
        edges_omega=part(g.edges_omega, (3, 3)),
        edge_mask=part(g.edge_mask, ()),
        n_edges=torch.tensor(El, dtype=torch.int32, device=dev),
    )
    with highest_matmul_precision():
        out, chi = _optimize_cg_level(g_l, cfg, sp.levels[0], mesh)
    return g._replace(poses=out.poses), chi
