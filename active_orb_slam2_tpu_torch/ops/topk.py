"""Top-k with the tie order of ``jax.lax.top_k``.

``jax.lax.top_k`` puts the lower index first among equal values;
``torch.topk`` gives no such order.  Several results of the JAX package
hang on that order (integer FAST scores, integer Hamming distances, the
lowest-index True entries of a mask), so the port selects through a
stable descending sort instead.
"""

import torch


def stable_topk(values, k: int):
    """(values [..., k], indices [..., k]) of the k largest entries along
    the last axis, lower index first among equal values."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
