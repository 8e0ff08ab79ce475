"""Carry SLAM state between the JAX package and the port.

SLAM has no weights; what crosses is the map arena and the tracking
state.  Both cross as dicts of numpy arrays keyed by the NamedTuple
field names (for the map, what the JAX package's ``System.checkpoint``
returns).  uint32 arrays (the descriptors) cross as int32 views with
the same bits, bools as bools.
"""

import numpy as np
import torch

from active_orb_slam2_tpu_torch.models.map_state import MapState
from active_orb_slam2_tpu_torch.models.tracking import TrackState


def to_torch(a, device=None):
    """numpy array -> tensor on ``device``; uint32 as int32 bits."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy()).to(device)     # copy keeps 0-d shape


def _to_numpy(t, uint32: bool):
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if uint32 else a


def map_from_jax_numpy(arrays: dict, device=None) -> MapState:
    """MapState on ``device`` from the JAX map's fields as numpy arrays."""
    return MapState(**{f: to_torch(arrays[f], device)
                       for f in MapState._fields})


def map_to_jax_numpy(m: MapState) -> dict:
    """The reverse: numpy arrays with the JAX package's dtypes (the
    descriptor fields back to uint32)."""
    return {f: _to_numpy(getattr(m, f), f.endswith("desc"))
            for f in MapState._fields}


def track_state_from_jax_numpy(arrays: dict, device=None) -> TrackState:
    """TrackState on ``device`` from the JAX state's fields as numpy
    arrays."""
    return TrackState(**{f: to_torch(arrays[f], device)
                         for f in TrackState._fields})


def track_state_to_jax_numpy(st: TrackState) -> dict:
    return {f: _to_numpy(getattr(st, f), f.endswith("desc"))
            for f in TrackState._fields}
