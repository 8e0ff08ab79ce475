"""Order statistics with the JAX package's conventions: top-k with the
tie order of ``jax.lax.top_k``, and ``jnp.nanmedian``.

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


def nanmedian(x, valid):
    """``jnp.nanmedian`` of x [N] over the entries where ``valid``: the
    mean of the two middle values for an even count (``torch.nanmedian``
    returns the lower one), NaN if none.  Reads nothing on the host."""
    s = torch.sort(torch.where(valid, x, float("inf"))).values
    n = valid.sum().view(1)
    at = torch.cat([torch.div(n - 1, 2, rounding_mode="floor"),
                    torch.div(n, 2, rounding_mode="floor")])
    mid = s.index_select(0, torch.clamp(at, 0, s.shape[0] - 1)).mean()
    return torch.where(n[0] > 0, mid, float("nan"))
