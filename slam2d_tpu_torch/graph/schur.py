"""Block Schur-complement pose-graph solver, port of
slam2d_tpu/graph/schur.py.

Nodes are split into contiguous keyframe blocks. Both endpoints of an
edge that crosses a block boundary are SEPARATORS (node 0, the anchor,
is one too); every other node is INTERIOR to its block. One Gauss-Newton
step then factors as

    per block:  S_b = H_ss,b - H_bs^T H_bb^-1 H_bs
                r_b = b_s,b - H_bs^T H_bb^-1 b_b
    reduce:     S = sum_b S_b,  r = sum_b r_b
    separators: S ds = -r
    per block:  db = H_bb^-1 (-b_b - H_bs ds)

`build_plan` makes the partition on the host from numpy (a `HostGraph`
holds the edge list there, so a solve reads nothing back from the card).
The iteration runs the blocks as one batch: batched
`torch.linalg.cholesky_ex` and triangular solves over the [NB, 3I, 3I]
blocks, a factorization that fails giving NaN as the JAX package's
`cho_factor` does; the products in full float32 (TF32 off, as the JAX
package asks for "highest" matmul precision: reduced-precision operands
make the near-singular systems indefinite).

Assembly: the plan is fixed within one `optimize_schur` call, so the
destination of every per-edge block entry in the blocks' [H_bb, H_bs,
H_ss, b_b, b_s] is worked out once a call on the host, grouped by
destination into a padded [U, M] table of sources. Each iteration
gathers the entries through it and sums each row in one reduction: a
fixed order, with no sort and no atomics (`index_put_(accumulate=True)`
sorts its indices at every launch).

`optimize_schur_sharded` splits the block axis over the ranks of a mesh
(parallel/mesh.py): each rank eliminates its own blocks, S, r, chi2 and
the interior deltas are summed over the ranks (psum), and the separator
system is solved on every rank.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam2d_tpu_torch.config import GraphConfig
from slam2d_tpu_torch.core import se2
from slam2d_tpu_torch.core.numerics import highest_matmul_precision
from slam2d_tpu_torch.graph.se2_graph import PoseGraph, _edge_blocks


class SchurPlan(NamedTuple):
    """Host-built partition plan (numpy), as the JAX package's."""

    sep_ids: np.ndarray       # [S] global node ids of the separators
    n_sep: int
    int_ids: np.ndarray       # [NB, I] interior node ids (padded -1)
    edge_idx: np.ndarray      # [NB, E_b] edge indices assigned to the block
    edge_mask: np.ndarray     # [NB, E_b]
    ei_slot: np.ndarray       # [NB, E_b] local slot of endpoint i
    ei_is_sep: np.ndarray     # [NB, E_b] bool: the slot indexes separators
    ej_slot: np.ndarray       # [NB, E_b]
    ej_is_sep: np.ndarray     # [NB, E_b]


def _host_int(x) -> int:
    return int(x.item()) if isinstance(x, torch.Tensor) else int(x)


def _host_array(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def build_plan(g, n_blocks: int) -> SchurPlan:
    """Partition the active nodes into `n_blocks` contiguous blocks and
    classify the separators. `g` is a HostGraph (numpy; nothing is read
    from a device) or a PoseGraph (its node and edge counts and edge list
    are read to the host)."""
    K = _host_int(g.n_nodes)
    E = _host_int(g.n_edges)
    if K == 0 or E == 0:
        raise ValueError(
            f"Schur plan needs a non-empty graph (nodes={K}, edges={E}); "
            "callers should return the graph unchanged instead"
        )
    ij = _host_array(g.edges_ij)[:E].astype(np.int64)
    blk_size = max(1, -(-K // n_blocks))
    block_of = np.minimum(np.arange(K) // blk_size, n_blocks - 1)

    cross = block_of[ij[:, 0]] != block_of[ij[:, 1]]
    is_sep = np.zeros(K, bool)
    is_sep[ij[cross].reshape(-1)] = True
    is_sep[0] = True  # the anchor joins the separator system

    sep_ids = np.flatnonzero(is_sep)
    S = len(sep_ids)
    sep_slot = np.full(K, -1, np.int64)
    sep_slot[sep_ids] = np.arange(S)

    int_lists, edge_lists = [], []
    int_slot = np.full(K, -1, np.int64)
    for b in range(n_blocks):
        ids = np.flatnonzero((block_of == b) & ~is_sep)
        int_slot[ids] = np.arange(len(ids))
        int_lists.append(ids)
        # an edge belongs to the block of its lower endpoint (cross edges
        # too: their separator blocks are then summed exactly once)
        edge_lists.append(np.flatnonzero(
            np.minimum(block_of[ij[:, 0]], block_of[ij[:, 1]]) == b
        ))

    I = max((len(x) for x in int_lists), default=1) or 1
    Eb = max((len(x) for x in edge_lists), default=1) or 1

    def pad(lists, width, fill):
        out = np.full((n_blocks, width), fill, np.int64)
        for b, lst in enumerate(lists):
            out[b, : len(lst)] = lst
        return out

    int_ids = pad(int_lists, I, -1)
    edge_idx = pad(edge_lists, Eb, 0)
    edge_mask = np.zeros((n_blocks, Eb), bool)
    for b, lst in enumerate(edge_lists):
        edge_mask[b, : len(lst)] = True

    ei = ij[edge_idx.reshape(-1), 0].reshape(n_blocks, Eb)
    ej = ij[edge_idx.reshape(-1), 1].reshape(n_blocks, Eb)
    ei_is_sep = is_sep[ei]
    ej_is_sep = is_sep[ej]
    ei_slot = np.where(ei_is_sep, sep_slot[ei], int_slot[ei])
    ej_slot = np.where(ej_is_sep, sep_slot[ej], int_slot[ej])

    return SchurPlan(
        sep_ids=sep_ids, n_sep=S,
        int_ids=int_ids,
        edge_idx=edge_idx, edge_mask=edge_mask,
        ei_slot=ei_slot, ei_is_sep=ei_is_sep,
        ej_slot=ej_slot, ej_is_sep=ej_is_sep,
    )


def _host_delta_eff(cfg: GraphConfig, it: int) -> float:
    """The robust threshold of Gauss-Newton iteration `it` (GNC annealing),
    a Python float as the JAX package's Schur solver computes it on the
    host (the caller rounds it to float32)."""
    if cfg.robust_kind == "none":
        return 0.0
    return cfg.robust_delta * 10.0 ** max(0, cfg.robust_gnc_iters - it)


class _Assembly(NamedTuple):
    """The fixed routing of one plan: for each destination entry `dest`
    (flat, in the concatenation of every block's [H_bb, H_bs, H_ss, b_b,
    b_s]), the row of `src` lists the flat indices of its per-edge
    sources (padded with the index of a trailing zero)."""

    dest: torch.Tensor    # [U] int64
    src: torch.Tensor     # [U, M] int64
    n_out: int


def _assembly(plan: SchurPlan, device) -> _Assembly:
    """Route every entry of every plan edge's (Hii, Hij, Hij^T, Hjj, bi,
    bj) to its place, as the JAX package's `_block_assemble` scatters
    them: Hii to H_bb or H_ss by endpoint i's class, Hij to H_bb (both
    interior), H_bs (i interior, j separator), its transpose to H_bs (i
    separator, j interior), both to H_ss (both separators); a masked-out
    plan slot adds nothing."""
    NB, Eb = plan.edge_idx.shape
    I = plan.int_ids.shape[1]
    S = plan.n_sep
    nI, nS = 3 * I, 3 * S
    sizes = [nI * nI, nI * nS, nS * nS, nI, nS]
    per_block = sum(sizes)
    base = np.cumsum([0] + sizes[:-1])    # Hbb, Hbs, Hss, bb, bs offsets
    n_e = NB * Eb
    # source layout: Hii, Hij, Hjj [n_e, 3, 3], then bi, bj [n_e, 3]
    off_hii, off_hij, off_hjj = 0, 9 * n_e, 18 * n_e
    off_bi, off_bj = 27 * n_e, 30 * n_e
    n_src = 33 * n_e

    m = plan.edge_mask.reshape(-1)
    i_sep = plan.ei_is_sep.reshape(-1)
    j_sep = plan.ej_is_sep.reshape(-1)
    i_slot = np.where(plan.ei_slot < 0, 0, plan.ei_slot).reshape(-1)
    j_slot = np.where(plan.ej_slot < 0, 0, plan.ej_slot).reshape(-1)
    blk = np.repeat(np.arange(NB), Eb)
    e = np.arange(n_e)
    a, c = np.meshgrid(np.arange(3), np.arange(3), indexing="ij")
    a, c = a.reshape(-1), c.reshape(-1)          # 3x3 entry (row, col)

    srcs, dsts = [], []

    def mat(sel, src_off, transpose, r_slot, c_slot, which, ncols):
        """Blocks of the edges `sel` into matrix `which` ([rows, ncols]),
        rows 3 * r_slot + a, cols 3 * c_slot + c."""
        ee = e[sel]
        if not len(ee):
            return
        # entry (a, c) of the block put at (a, c); of its transpose
        # at (c, a): the source of destination (a, c) is (c, a)
        s_ac = 3 * c + a if transpose else 3 * a + c
        srcs.append((src_off + 9 * ee[:, None] + s_ac[None, :]).reshape(-1))
        row = 3 * r_slot[sel][:, None] + a[None, :]
        col = 3 * c_slot[sel][:, None] + c[None, :]
        dsts.append((blk[sel][:, None] * per_block + base[which]
                     + row * ncols + col).reshape(-1))

    def vec(sel, src_off, slot, which):
        ee = e[sel]
        if not len(ee):
            return
        k = np.arange(3)
        srcs.append((src_off + 3 * ee[:, None] + k[None, :]).reshape(-1))
        dsts.append((blk[sel][:, None] * per_block + base[which]
                     + 3 * slot[sel][:, None] + k[None, :]).reshape(-1))

    HBB, HBS, HSS, BB, BS = range(5)
    ii, si, ij_, sj = m & ~i_sep, m & i_sep, m & ~j_sep, m & j_sep
    mat(ii, off_hii, False, i_slot, i_slot, HBB, nI)
    mat(si, off_hii, False, i_slot, i_slot, HSS, nS)
    mat(ij_, off_hjj, False, j_slot, j_slot, HBB, nI)
    mat(sj, off_hjj, False, j_slot, j_slot, HSS, nS)
    mat(ii & ij_, off_hij, False, i_slot, j_slot, HBB, nI)
    mat(ii & ij_, off_hij, True, j_slot, i_slot, HBB, nI)
    mat(ii & sj, off_hij, False, i_slot, j_slot, HBS, nS)
    mat(si & ij_, off_hij, True, j_slot, i_slot, HBS, nS)
    mat(si & sj, off_hij, False, i_slot, j_slot, HSS, nS)
    mat(si & sj, off_hij, True, j_slot, i_slot, HSS, nS)
    vec(ii, off_bi, i_slot, BB)
    vec(si, off_bi, i_slot, BS)
    vec(ij_, off_bj, j_slot, BB)
    vec(sj, off_bj, j_slot, BS)

    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    dest, first, counts = np.unique(dst, return_index=True,
                                    return_counts=True)
    M = int(counts.max()) if len(counts) else 1
    table = np.full((len(dest), M), n_src, np.int64)   # n_src: the zero
    rank = np.arange(len(dst)) - np.repeat(first, counts)
    table[np.repeat(np.arange(len(dest)), counts), rank] = src
    return _Assembly(
        dest=torch.as_tensor(dest, device=device),
        src=torch.as_tensor(table, device=device),
        n_out=NB * per_block,
    )


class _PlanTensors(NamedTuple):
    edge_idx: torch.Tensor    # [NB * Eb] int64
    plan_mask: torch.Tensor   # [NB * Eb] bool
    pad: torch.Tensor         # [NB, 3I] float32: 1 on padded interior slots
    int_pos: torch.Tensor     # [n_int] flat positions of valid interiors
    int_ids: torch.Tensor     # [n_int] their node ids
    sep_ids: torch.Tensor     # [S] int64
    anchor: torch.Tensor      # [3S] float32: 1e8 on node 0's three rows
    asm: _Assembly


def schur_tables(plan: SchurPlan, device) -> _PlanTensors:
    """The plan's index tensors and assembly table on `device`, built on
    the host (numpy) and copied over once: what every Gauss-Newton
    iteration of `optimize_schur` reuses. Pass them back as `tables=` to
    solve again on the same plan without rebuilding them."""
    S = plan.n_sep
    valid = plan.int_ids >= 0
    anchor = np.zeros(3 * S, np.float32)
    slot = int(np.argmax(plan.sep_ids == 0))
    anchor[3 * slot : 3 * slot + 3] = 1e8
    pos = np.flatnonzero(valid.reshape(-1))

    def t(a):
        return torch.as_tensor(a, device=device)

    return _PlanTensors(
        edge_idx=t(plan.edge_idx.reshape(-1)),
        plan_mask=t(plan.edge_mask.reshape(-1)),
        pad=t(np.repeat(~valid, 3, axis=1).astype(np.float32)),
        int_pos=t(pos), int_ids=t(plan.int_ids.reshape(-1)[pos]),
        sep_ids=t(plan.sep_ids.astype(np.int64)), anchor=t(anchor),
        asm=_assembly(plan, device),
    )


def _cholesky(A):
    """Lower Cholesky factors of the batch A, all NaN where one fails."""
    L, info = torch.linalg.cholesky_ex(A)
    ok = (info == 0)[..., None, None]
    return torch.where(ok, L, torch.full_like(L, torch.nan))


def _cho_solve(L, B):
    """A^-1 B from A's lower Cholesky factor L (batched): two triangular
    solves. torch.cholesky_solve computes the same on CUDA through a
    batched MAGMA call whose host side takes ~1.2 ms a call on an H100
    host (PERF.md §6, PR 12), 30 times the device's; cuBLAS's batched
    triangular solves do not."""
    y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-2, -1), y, upper=True)


def _assemble(poses, g: PoseGraph, pt: _PlanTensors, I: int, S: int,
              robust=None):
    """Every block's (H_bb [NB, 3I, 3I], H_bs [NB, 3I, 3S], H_ss
    [NB, 3S, 3S], b_b [NB, 3I], b_s [NB, 3S]) and the summed chi2 (0-d),
    the JAX package's `_block_assemble` of each block, through the plan's
    fixed routing."""
    NB = pt.pad.shape[0]
    nI, nS = 3 * I, 3 * S
    ei = pt.edge_idx
    mask = pt.plan_mask & g.edge_mask[ei]
    Hii, Hij, Hjj, bi, bj, chi = _edge_blocks(
        poses, g.edges_ij[ei], g.edges_z[ei], g.edges_omega[ei], mask, robust,
    )
    src = torch.cat([Hii.reshape(-1), Hij.reshape(-1), Hjj.reshape(-1),
                     bi.reshape(-1), bj.reshape(-1), chi.new_zeros(1)])
    out = src.new_zeros(pt.asm.n_out)
    out[pt.asm.dest] = src[pt.asm.src].sum(-1)
    Hbb, Hbs, Hss, bb, bs = torch.split(
        out.reshape(NB, -1), [nI * nI, nI * nS, nS * nS, nI, nS], dim=1)
    return (Hbb.reshape(NB, nI, nI), Hbs.reshape(NB, nI, nS),
            Hss.reshape(NB, nS, nS), bb, bs, chi.sum())


def _iteration_core_f32(poses, g: PoseGraph, pt: _PlanTensors, I: int,
                        S: int, cfg: GraphConfig, robust_delta_eff,
                        mesh=None):
    """One Gauss-Newton iteration over every block of `pt`; returns (new
    poses [K, 3], chi2 of this linearization, a 0-d tensor). With a
    `mesh`, `pt` holds this rank's blocks and the separator system, the
    chi2 and the interior deltas are summed over the ranks."""
    robust = (
        None if cfg.robust_kind == "none"
        else (cfg.robust_kind, robust_delta_eff)
    )
    Hbb, Hbs, Hss, bb, bs, chi = _assemble(poses, g, pt, I, S, robust)

    # damping, and an identity on padded interior slots, keep H_bb
    # invertible
    Hbb = 0.5 * (Hbb + Hbb.transpose(1, 2)) + torch.diag_embed(
        pt.pad + cfg.damping)
    L = _cholesky(Hbb)
    HinvB = _cho_solve(L, Hbs)                            # H_bb^-1 H_bs
    Hinvb = _cho_solve(L, bb[..., None])                  # H_bb^-1 b_b
    HbsT = Hbs.transpose(1, 2)
    S_tot = (Hss - HbsT @ HinvB).sum(0)
    r_tot = (bs - (HbsT @ Hinvb)[..., 0]).sum(0)
    if mesh is not None:
        S_tot, r_tot, chi = mesh.psum(S_tot), mesh.psum(r_tot), mesh.psum(chi)

    # node 0 is always a separator: pin it
    S_tot = 0.5 * (S_tot + S_tot.T) + torch.diag(pt.anchor + cfg.damping)
    ds = _cho_solve(_cholesky(S_tot), (-r_tot)[:, None])[:, 0]

    # back-substitute every block's interiors
    db = _cho_solve(L, -bb[..., None] - Hbs @ ds[None, :, None])[..., 0]
    # interiors and separators are disjoint, each id once
    delta = torch.zeros_like(poses)
    delta[pt.int_ids] = db.reshape(-1, 3)[pt.int_pos]
    if mesh is not None:
        # each interior is one rank's; the other ranks add 0
        delta = mesh.psum(delta)
    delta[pt.sep_ids] = ds.reshape(S, 3)
    new = poses + delta
    return (torch.cat([new[:, :2], se2.wrap_angle(new[:, 2:3])], dim=1),
            chi)


def optimize_schur(g: PoseGraph, cfg: GraphConfig, n_blocks: int = 4,
                   plan: SchurPlan | None = None,
                   tables: _PlanTensors | None = None):
    """cfg.gn_iters Gauss-Newton iterations by block Schur elimination, the
    blocks as one batch on the graph's device; returns (graph with the new
    poses, chi2 of the last linearization as a 0-d tensor).

    `plan` is build_plan's partition of the same graph (build it from the
    HostGraph, on the host); without one it is built from `g`, which
    reads the graph's counts and edge list back to the host. `tables` are
    schur_tables(plan, device), built here when not given. An empty graph
    comes back unchanged with a chi2 of 0."""
    if plan is None:
        if _host_int(g.n_nodes) == 0 or _host_int(g.n_edges) == 0:
            return g, torch.zeros((), dtype=torch.float32,
                                  device=g.poses.device)
        plan = build_plan(g, n_blocks)
    pt = schur_tables(plan, g.poses.device) if tables is None else tables
    I = plan.int_ids.shape[1]
    poses = g.poses
    chi = torch.zeros((), dtype=torch.float32, device=poses.device)
    with highest_matmul_precision():
        for it in range(cfg.gn_iters):
            poses, chi = _iteration_core_f32(
                poses, g, pt, I, plan.n_sep, cfg,
                np.float32(_host_delta_eff(cfg, it)),
            )
    return g._replace(poses=poses), chi


def block_slice(plan: SchurPlan, lo: int, hi: int) -> SchurPlan:
    """The plan of blocks [lo, hi) alone, the same separators."""
    return plan._replace(**{
        f: getattr(plan, f)[lo:hi]
        for f in ("int_ids", "edge_idx", "edge_mask", "ei_slot",
                  "ei_is_sep", "ej_slot", "ej_is_sep")
    })


def optimize_schur_sharded(g: PoseGraph, cfg: GraphConfig, mesh,
                           n_blocks: int | None = None,
                           plan: SchurPlan | None = None):
    """optimize_schur with the BLOCK axis split over the ranks of `mesh`,
    the JAX package's optimize_schur_sharded: n_blocks (default the world
    size; a multiple of it) blocks, rank r eliminating blocks [r * NB /
    n, (r + 1) * NB / n); S, r, chi2 and the interior deltas are summed
    over the ranks and the separator solve runs on every rank. Every rank
    passes the same graph (and `plan`, build_plan(host_graph, n_blocks),
    built here from `g` when not given) and gets the same poses."""
    n = mesh.world_size
    n_blocks = n_blocks or n
    if n_blocks % n:
        raise ValueError(f"n_blocks={n_blocks} must be a multiple of the "
                         f"world size {n}")
    if plan is None:
        if _host_int(g.n_nodes) == 0 or _host_int(g.n_edges) == 0:
            return g, torch.zeros((), dtype=torch.float32,
                                  device=g.poses.device)
        plan = build_plan(g, n_blocks)
    if plan.int_ids.shape[0] != n_blocks:
        raise ValueError(f"the plan has {plan.int_ids.shape[0]} blocks, "
                         f"not {n_blocks}")
    per = n_blocks // n
    local = block_slice(plan, mesh.rank * per, (mesh.rank + 1) * per)
    pt = schur_tables(local, g.poses.device)
    I = plan.int_ids.shape[1]
    poses = g.poses
    chi = torch.zeros((), dtype=torch.float32, device=poses.device)
    with highest_matmul_precision():
        for it in range(cfg.gn_iters):
            poses, chi = _iteration_core_f32(
                poses, g, pt, I, plan.n_sep, cfg,
                np.float32(_host_delta_eff(cfg, it)), mesh=mesh,
            )
    return g._replace(poses=poses), chi
