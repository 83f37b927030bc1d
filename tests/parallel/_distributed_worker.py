"""Worker process for the 2-process jax.distributed test.

Launched by ``test_distributed.py`` with argv: coordinator_address,
num_processes, process_id.  Initialises the distributed backend through the
framework's own entry point, reduces a host-local scalar across processes,
and prints one JSON line for the parent to assert on.
"""

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from tile_match_tpu.parallel.distributed import (  # noqa: E402
    all_hosts_mean,
    initialize_distributed,
)


def main():
    addr, nprocs, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    ok = initialize_distributed(
        coordinator_address=addr, num_processes=nprocs, process_id=pid
    )
    import jax.numpy as jnp

    local = jnp.float32(pid + 1.0)  # host-local metric: 1.0 and 2.0
    mean = float(all_hosts_mean(local))
    print(
        json.dumps(
            {
                "initialized": bool(ok),
                "process_count": jax.process_count(),
                "process_index": jax.process_index(),
                "mean": mean,
            }
        )
    )


if __name__ == "__main__":
    main()
