"""Sim3 pose-graph optimization (the essential graph).

Port of ``active_orb_slam2_tpu/models/pose_graph.py``
(``Optimizer::OptimizeEssentialGraph``): 7-DoF Sim3 vertices over
spanning-tree, strong-covisibility and loop edges, residual
``log(S_meas^-1 S_j S_i^-1)`` per edge, 20 LM iterations on the dense
[7K, 7K] normal equations.  The per-edge Jacobians come from one
``torch.func.jacfwd`` over all edges at once (each edge's residual
depends only on its own perturbation, so the Jacobian of the stacked
residuals by a shared 7-vector is the stack of the per-edge ones); the
blocks go into ``Hb`` [K*K, 7, 7] by ``index_add_``, and the system is
solved by ``cholesky_ex`` / ``cholesky_solve``, which do not wait on the
card (float32; TF32 stays off).
"""

from typing import NamedTuple

import torch

from active_orb_slam2_tpu_torch.geometry.se3 import (
    sim3_compose, sim3_exp, sim3_inverse, sim3_log)
from active_orb_slam2_tpu_torch.ops.topk import stable_topk


class Sim3Edges(NamedTuple):
    """Relative Sim3 constraints i -> j (fixed shape E)."""
    i: torch.Tensor         # [E] int
    j: torch.Tensor         # [E] int
    meas_ji: torch.Tensor   # [E, 8] measured S_j S_i^-1
    valid: torch.Tensor     # [E] bool
    weight: torch.Tensor    # [E] information scale


def _edge_residual(delta_i, delta_j, S_i, S_j, meas_ji):
    Si = sim3_compose(sim3_exp(delta_i), S_i)
    Sj = sim3_compose(sim3_exp(delta_j), S_j)
    return sim3_log(sim3_compose(sim3_inverse(meas_ji),
                                 sim3_compose(Sj, sim3_inverse(Si))))


def optimize_essential_graph(kf_sim3, edges: Sim3Edges, fixed,
                             iters: int = 20, lam0: float = 1e-6):
    """LM over the pose graph: kf_sim3 [K, 8], fixed [K] bool (the loop
    keyframe and the invalid slots).  Returns (optimized [K, 8], final
    chi2)."""
    K = kf_sim3.shape[0]
    dev = kf_sim3.device
    E = edges.i.shape[0]
    ei, ej = edges.i.long(), edges.j.long()
    w = torch.where(edges.valid, edges.weight, 0.0)
    zeros = torch.zeros((E, 7), device=dev)
    eye = torch.eye(7 * K, device=dev)
    rows = fixed[:, None].expand(K, 7).reshape(-1)
    pinned = rows[:, None] | rows[None, :]
    free = (~fixed).to(torch.float32)[:, None]

    def chi2_of(S):
        r = _edge_residual(zeros, zeros, S[ei], S[ej], edges.meas_ji)
        return (w * (r * r).sum(-1)).sum()

    def gram(Ja, Jb):
        return torch.einsum("eai,e,eaj->eij", Ja, w, Jb)

    S = kf_sim3
    lam = torch.full((), lam0, device=dev)
    chi2 = torch.zeros((), device=dev)
    c_S = chi2_of(S)
    zero14 = torch.zeros(14, device=dev)
    for _ in range(iters):
        Si, Sj = S[ei], S[ej]

        def res(d):
            r = _edge_residual(d[:7].expand(E, 7), d[7:].expand(E, 7), Si,
                               Sj, edges.meas_ji)
            return r, r
        # both perturbations in one forward-mode pass: [E, 7, 14]
        J, r = torch.func.jacfwd(res, has_aux=True)(zero14)
        Ji, Jj = J[..., :7], J[..., 7:]
        Hij = gram(Ji, Jj)
        Hb = torch.zeros((K * K, 7, 7), device=dev)
        Hb.index_add_(0, ei * K + ei, gram(Ji, Ji))
        Hb.index_add_(0, ej * K + ej, gram(Jj, Jj))
        Hb.index_add_(0, ei * K + ej, Hij)
        Hb.index_add_(0, ej * K + ei, Hij.transpose(-1, -2))
        g = torch.zeros((K, 7), device=dev)
        g.index_add_(0, ei, -torch.einsum("eai,e,ea->ei", Ji, w, r))
        g.index_add_(0, ej, -torch.einsum("eai,e,ea->ei", Jj, w, r))
        H = Hb.view(K, K, 7, 7).transpose(1, 2).reshape(7 * K, 7 * K)
        del Hb
        # the constant diagonal is a gauge prior (the JAX package's 1e-3):
        # components cut off from the pinned keyframe stay near their
        # current estimates
        H = H + lam * torch.diag(torch.diagonal(H)) + 1e-3 * eye
        H = torch.where(pinned, eye, H)
        gv = torch.where(rows, 0.0, g.reshape(-1))
        L, _ = torch.linalg.cholesky_ex(H)
        del H
        d = torch.cholesky_solve(gv[:, None], L)[:, 0].view(K, 7) * free
        del L
        S_new = sim3_compose(sim3_exp(d), S)
        c_new = chi2_of(S_new)
        accept = c_new <= c_S
        S = torch.where(accept, S_new, S)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 8.0), 1e-9, 1e2)
        chi2 = c_S = torch.where(accept, c_new, c_S)
    return S, chi2


def build_essential_edges(kf_sim3, kf_valid, kf_parent, covis_W, loop_i,
                          loop_j, strong_th: int = 100, max_strong: int = 512,
                          max_loop: int = 32):
    """The essential graph's edge list from the arena: spanning tree
    (parent -> k), the ``max_strong`` strongest covisibility pairs of the
    upper triangle with weight >= ``strong_th``, and the loop edges
    (index arrays padded with -1).  ``kf_sim3`` are the measurements'
    poses (before the correction)."""
    K = kf_sim3.shape[0]
    dev = kf_sim3.device
    max_strong = min(max_strong, K * K)

    def rel(i, j):
        return sim3_compose(kf_sim3[j], sim3_inverse(kf_sim3[i]))

    ks = torch.arange(K, device=dev)
    pi = torch.clamp(kf_parent, min=0).long()
    tree_valid = kf_valid & (kf_parent >= 0) & kf_valid[pi]

    W = torch.where(kf_valid[:, None] & kf_valid[None, :], covis_W, 0)
    vals, idx = stable_topk(torch.triu(W, 1).reshape(-1), max_strong)
    ci, cj = idx // K, idx % K

    li = torch.clamp(loop_i, min=0).long()
    lj = torch.clamp(loop_j, min=0).long()
    loop_valid = (loop_i >= 0) & (loop_j >= 0)
    ii = torch.cat([pi, ci, li])
    jj = torch.cat([ks, cj, lj])
    return Sim3Edges(
        i=ii.to(torch.int32), j=jj.to(torch.int32), meas_ji=rel(ii, jj),
        valid=torch.cat([tree_valid, vals >= strong_th, loop_valid]),
        weight=torch.cat([torch.ones(K + max_strong, device=dev),
                          torch.full(loop_i.shape, 5.0, device=dev)]))
