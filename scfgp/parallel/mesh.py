"""Device mesh construction and row sharding for data-parallel training.

The reference is single-process/single-device (SURVEY.md §2.4); this module
provides the scaling story: a 1-D ``data`` mesh over all local (or
multi-host) devices, rows of (X, y) sharded across it, padding rows carried
with zero weights so the sharded objective is *exactly* the full-batch
objective (see ``scfgp.models.objective.loss_fn``'s weighted stats).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
FEATURE_AXIS = "feature"


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = DATA_AXIS) -> Mesh:
    """1-D mesh over the given (default: all) devices."""
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.array(devices), (axis_name,))


def make_mesh2d(n_data: int, n_feature: int,
                devices: Optional[Sequence] = None) -> Mesh:
    """2-D (data, feature) mesh for combined data + tensor parallelism.

    The GPUs of one host are joined all to all by NVLink, so the mesh
    shape follows the algorithm alone: the ``feature`` axis carries the
    per-step all_gather of the Phi strips and psum of Gram block-columns
    (``parallel/tp.py``), the ``data`` axis the once-per-step stats psum.
    Across hosts, keep the ``feature`` axis within a host.
    """
    devices = list(devices if devices is not None else jax.devices())
    assert len(devices) >= n_data * n_feature, (
        f"need {n_data * n_feature} devices, have {len(devices)}")
    grid = np.array(devices[:n_data * n_feature]).reshape(n_data, n_feature)
    return Mesh(grid, (DATA_AXIS, FEATURE_AXIS))


def pad_rows(X: np.ndarray, y: np.ndarray, multiple: int):
    """Pad rows to a multiple of the shard count; returns (X, y, w) with
    weight 0 on padding rows.  Exactness is guaranteed by the weighted
    sufficient statistics (tests: test_objective.py padding invariance)."""
    n = X.shape[0]
    pad = (-n) % multiple
    w = np.ones(n, X.dtype)
    if pad:
        X = np.concatenate([X, np.zeros((pad, X.shape[1]), X.dtype)], axis=0)
        y = np.concatenate([y.reshape(-1), np.zeros(pad, X.dtype)])
        w = np.concatenate([w, np.zeros(pad, X.dtype)])
    return X, y.reshape(-1), w


def shard_rows(mesh: Mesh, X, y, w=None, axis_name: str = DATA_AXIS):
    """Place (X, y, w) row-sharded on the mesh; pads if needed."""
    n_shards = mesh.shape[axis_name]
    X = np.asarray(X)
    y = np.asarray(y).reshape(-1)
    if w is None:
        X, y, w = pad_rows(X, y, n_shards)
    row_sharding = NamedSharding(mesh, P(axis_name))
    Xs = jax.device_put(X, NamedSharding(mesh, P(axis_name, None)))
    ys = jax.device_put(y, row_sharding)
    ws = jax.device_put(w, row_sharding)
    return Xs, ys, ws


def replicated(mesh: Mesh):
    """Sharding for fully-replicated PyTrees (params, optimizer state)."""
    return NamedSharding(mesh, P())
