"""Descriptor matching: Hamming distances and gated association searches.

Port of ``active_orb_slam2_tpu/ops/matching.py``.  PyTorch has no
popcount, so the Hamming matrix unpacks the bits to +-1 float32 and
takes one matrix product: hamming = (256 - <a, b>) / 2.  The products
are +-1 and the sums at most 256, so float32 is exact (TF32 stays off,
PyTorch's default on the card).
"""

import math

import torch

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30
INF = 1e9


def pm_descriptors(desc):
    """Packed descriptors [N, 8] int32 -> +-1 float32 [N, 256]
    (bit b -> 2b - 1; bit 32 w + j is bit j of word w)."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[..., :, None] >> shifts) & 1
    bits = bits.reshape(desc.shape[:-1] + (256,))
    return 2.0 * bits.to(torch.float32) - 1.0


def hamming_matrix(desc_a, desc_b, valid_a=None, valid_b=None):
    """All-pairs Hamming distances [..., M, N] float32 (exact integers) of
    desc_a [..., M, 8] and desc_b [..., N, 8] (leading axes broadcast);
    invalid rows / columns get INF."""
    dot = pm_descriptors(desc_a) @ pm_descriptors(desc_b).transpose(-1, -2)
    d = 0.5 * (256.0 - dot)
    if valid_a is not None:
        d = torch.where(valid_a[..., :, None], d, INF)
    if valid_b is not None:
        d = torch.where(valid_b[..., None, :], d, INF)
    return d


def _best_two(d):
    """Row-wise (best, second, argbest) with the lower index first on
    ties, as ``jax.lax.top_k(-d, 2)`` gives them."""
    jbest = torch.argmin(d, dim=-1, keepdim=True)         # first min wins
    best = d.gather(-1, jbest)[..., 0]
    second = d.scatter(-1, jbest, float("inf")).amin(-1)
    return best, second, jbest[..., 0]


def match_mutual(d, max_dist: float = TH_LOW, ratio: float = 1.0):
    """Mutual-best match with ratio test on a gated distance matrix
    [..., M, N] (leading axes are independent matrices).

    Returns (match_idx [..., M] int32 into columns, -1 if none; dist
    [..., M]).
    """
    best, second, jbest = _best_two(d)
    col_best_i = torch.argmin(d, dim=-2)                 # first min wins
    mutual = col_best_i.gather(-1, jbest) == torch.arange(
        d.shape[-2], device=d.device)
    ok = (best <= max_dist) & (best < ratio * second) & mutual
    return torch.where(ok, jbest, -1).to(torch.int32), best


def search_by_projection(proj_uv, radii, pred_level, query_desc, query_valid,
                         feats_uv, feats_level, feats_desc, feats_valid,
                         max_dist: float = TH_HIGH, ratio: float = 1.0,
                         level_window: int = 1):
    """Projection-gated association (``SearchByProjection``).

    proj_uv [M, 2] projected points, radii [M] search radius in px,
    pred_level [M] predicted octave, query_desc [M, 8]; feats_* are the
    frame's features [N, ...].  The query arrays may have leading batch
    axes, each batch searching the same frame.  Returns (match_idx [M]
    int32, dist [M]), with the query's leading axes.
    """
    d = hamming_matrix(query_desc, feats_desc, query_valid, feats_valid)
    du = proj_uv[..., :, 0:1] - feats_uv[..., None, :, 0]
    dv = proj_uv[..., :, 1:2] - feats_uv[..., None, :, 1]
    within = (du * du + dv * dv) <= (radii[..., :, None] * radii[..., :, None])
    lv_ok = (feats_level[..., None, :] - pred_level[..., :, None]).abs() \
        <= level_window
    d = torch.where(within & lv_ok, d, INF)
    return match_mutual(d, max_dist=max_dist, ratio=ratio)


def rotation_consistency_mask(angle_q, angle_t, match_idx):
    """Keep matches whose angle difference falls in the 3 most populated
    of 30 orientation bins (bins 2 and 3 only at >= 10% of the first).

    Returns bool [M] (False where unmatched).
    """
    matched = match_idx >= 0
    rot = angle_q - angle_t[torch.clamp(match_idx, min=0).long()]
    rot = torch.remainder(rot, 2.0 * math.pi)
    binw = 2.0 * math.pi / HISTO_LENGTH
    bin_id = torch.clamp((rot / binw).to(torch.int32), 0, HISTO_LENGTH - 1)
    hist = torch.zeros(HISTO_LENGTH, dtype=torch.int32, device=rot.device)
    hist.index_add_(0, bin_id, matched.to(torch.int32))
    top3 = torch.sort(hist, descending=True).values[:3]
    h = hist[bin_id]
    in_top3 = h >= top3[2]
    big_enough = h.to(torch.float32) >= 0.1 * top3[0].to(torch.float32)
    return matched & in_top3 & big_enough
