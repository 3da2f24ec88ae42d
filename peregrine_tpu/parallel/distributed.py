"""Multi-host execution support.

The reference's multi-machine story is "run chunks on different machines
against a shared filesystem" (SURVEY.md §2.3).  Here multi-host runs use
jax.distributed: every host calls init_distributed(), after which
jax.devices() spans every rank's devices and the sharded index/exchange
programs (parallel.sharded_index) run unchanged over the global mesh —
reads stay data-parallel across all devices, SHIMMER records ride the
all_to_all to their hash shard.  Each rank owns its own devices: two
ranks on one GPU would each reserve most of its memory, so ranks on one
multi-GPU host are launched with disjoint CUDA_VISIBLE_DEVICES.

Stage files remain host-local checkpoints; only the rank-0 host writes
merged outputs.  (Single-host environments: this module is a no-op.)
"""

from __future__ import annotations

import jax


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> int:
    """Initialize multi-host JAX; returns this host's process index.

    Safe to call on single-host setups only when coordinator details are
    provided; otherwise skip.
    """
    if coordinator_address is None and num_processes is None:
        # single-process fallback: nothing to initialize
        return 0
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return jax.process_index()


def is_primary() -> bool:
    return jax.process_index() == 0


def global_mesh(axis: str = "data"):
    """Mesh over every device in the (possibly multi-host) runtime."""
    from .sharded_index import make_mesh
    return make_mesh(len(jax.devices()), axis=axis)
