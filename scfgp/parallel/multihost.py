"""Multi-host process-group initialization (SURVEY.md §2.4 backend row).

All cross-device communication in this framework is XLA collectives compiled
from ``psum``/sharding annotations — there is no hand-written transport.
This module is the thin entry point that joins several processes (one per
host, or one per GPU) into one JAX process group; XLA hands the collectives
to NCCL, over NVLink within a host and the network across hosts.

Usage in each process (before any other JAX call):

    from scfgp.parallel.multihost import init_distributed
    init_distributed("10.0.0.1:1234", num_processes=2, process_id=rank)
    mesh = make_mesh()            # now spans ALL processes' devices

With no coordinator address (argument or ``COORDINATOR_ADDRESS``) it is a
no-op, so code written against this API runs unchanged from one process to
many.  One process that owns all four GPUs of a host needs no call at all.
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> dict:
    """Join the multi-host process group; no-op if single-process.

    ``coordinator_address`` defaults to the ``COORDINATOR_ADDRESS``
    environment variable; pass ``num_processes`` and ``process_id`` with it
    unless JAX's own cluster detection supplies them.  Returns a summary
    dict (process index/count, local/global device counts).
    """
    # Probe WITHOUT touching the backend: jax.process_count() would
    # initialize XLA, after which jax.distributed.initialize() refuses to
    # run (found by tests/test_multihost.py — the round-1 version of this
    # check made the join a silent no-op on every real cluster).
    coordinator_address = (coordinator_address
                           or os.environ.get("COORDINATOR_ADDRESS"))
    already = jax.distributed.is_initialized()
    if not already and coordinator_address is not None:
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id)
        except RuntimeError as e:
            # Backend already initialized (e.g. a dev loop where
            # COORDINATOR_ADDRESS is set but JAX was touched first): stay
            # single-process rather than failing.
            import warnings
            warnings.warn(f"init_distributed: staying single-process ({e})")
    return {
        "process_id": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def is_coordinator() -> bool:
    """True on the process that should write checkpoints/logs."""
    return jax.process_index() == 0
