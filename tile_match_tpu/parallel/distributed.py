"""Multi-host initialisation and cross-host metric reduction.

The env batch is host-local (independent boards ⇒ no cross-host traffic on
the step path); jax.distributed wires the hosts into one global mesh so a
sharded learner and psum'd metrics span every host's devices.
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialise jax.distributed when running multi-host.

    Arguments left out are read from JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID.  With neither a coordinator nor a
    process count it is a single-process run: nothing to do, returns False.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    num_processes = num_processes or _int_env("JAX_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _int_env("JAX_PROCESS_ID")

    if coordinator_address is None and num_processes is None:
        return False

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def _int_env(name):
    v = os.environ.get(name)
    return int(v) if v is not None else None


def all_hosts_mean(x):
    """Mean of a host-local scalar across processes (runs a tiny psum)."""
    if jax.process_count() == 1:
        return x
    from jax.experimental import multihost_utils

    return multihost_utils.process_allgather(x).mean()
