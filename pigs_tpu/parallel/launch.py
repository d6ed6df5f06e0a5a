"""Multi-process initialization.

The reference is single-process (SURVEY.md §2.2); when several processes (one
per host, or one per GPU) run the same program, each must join the global
runtime before building meshes.  Call :func:`initialize_distributed` first
thing in such a program; it is a no-op in a single process.
"""

from __future__ import annotations

from typing import Optional

import jax

__all__ = ["initialize_distributed", "is_multihost", "host_summary"]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Join the jax distributed runtime when running several processes.

    Nothing discovers a cluster: pass ``coordinator_address``
    (``host:port``), ``num_processes`` and ``process_id``, or leave
    ``coordinator_address`` None for a single process.  Returns True if
    distributed mode was initialized.
    """
    if jax.process_count() > 1:
        return True
    if coordinator_address is None:
        return False  # single process: nothing to do
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def is_multihost() -> bool:
    return jax.process_count() > 1


def host_summary() -> str:
    return (f"process {jax.process_index()}/{jax.process_count()}, "
            f"{jax.local_device_count()} local / {jax.device_count()} global "
            f"devices")
