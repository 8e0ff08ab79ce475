"""Descriptor matching with the query rows sharded over a process mesh.

Port of ``active_orb_slam2_tpu/parallel/matcher.py``.  Bulk matching
problems (vocabulary training assignments, map-merge association,
offline loop retrieval over thousands of keyframes) build [M, N] Hamming
matrices that outgrow one card.  Each rank builds its row block with
``ops/matching.py::hamming_matrix`` and keeps the row-wise best; the
mutual check needs the global per-column best, one ``all_reduce(MIN)``
of [N] distances, the only collective before the [M] results are
gathered.
"""

import torch
import torch.distributed as dist

from active_orb_slam2_tpu_torch.ops.matching import _best_two, hamming_matrix
from active_orb_slam2_tpu_torch.parallel.mesh import MeshShards


def build_sharded_matcher(mesh, axis="shard", max_dist: float = 50.0,
                          ratio: float = 1.0):
    """``fn(desc_q [M, 8], valid_q [M], desc_t [N, 8], valid_t [N]) ->
    (match_idx [M] int32, -1 if none; dist [M])``, which every rank of
    ``mesh`` calls with the whole arrays.  The query rows are split over
    ``axis``, the targets replicated; the outputs come back whole on
    every rank.  A row matches its best column when that distance is at
    most ``max_dist``, below ``ratio`` times the row's second best and
    no larger than the column's best over all rows (so rows tied at a
    column's best all keep it, as in the JAX package).  Raises ValueError
    when M does not split into equal blocks."""
    shards = MeshShards(mesh, axis)

    def fn(desc_q, valid_q, desc_t, valid_t):
        lo, hi = shards.block(desc_q.shape[0])
        d = hamming_matrix(desc_q[lo:hi], desc_t, valid_q[lo:hi], valid_t)
        best, second, jbest = _best_two(d)
        col_best = shards.reduce(d.amin(0), dist.ReduceOp.MIN)
        mutual = best <= col_best[jbest] + 1e-6
        ok = (best <= max_dist) & (best < ratio * second) & mutual
        idx = torch.where(ok, jbest, -1).to(torch.int32)
        return shards.gather(idx), shards.gather(best)

    fn.shards = shards
    return fn
