"""Multi-process bootstrap for sharded CAVI training.

The reference is a single process with no distributed backend at all
(SURVEY §5: no MPI/NCCL/Gloo; pthread linked but never used). Across
hosts the runtime layer below the mesh is `jax.distributed`: one Python
process per host, every device of every host visible as `jax.devices()`
after initialization. The training code in `parallel/sharded.py` is
topology-agnostic — it shards over a single mesh axis spanning every
device, and XLA emits the per-iteration psums from the same code.

Usage (same script on every process, with the JAX_* variables below
set, or the arguments passed):

    from hgaprec_jax.parallel import distributed
    distributed.initialize_from_env()   # no-op for single-process runs
    run = build_sharded_run(store, cfg)  # mesh over all devices
"""

from __future__ import annotations

import os
from typing import Optional


def initialize_from_env(coordinator: Optional[str] = None,
                        num_processes: Optional[int] = None,
                        process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed when a coordinator is given.

    Resolution order: explicit arguments, then the standard JAX
    coordinator variables (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID). Nothing is detected from the environment beyond
    them. Returns True when distributed mode was initialized, False for a
    plain single-process run (nothing to do — jax.devices() is already
    the full local set).
    """
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator is None:
        return False
    env_np = os.environ.get("JAX_NUM_PROCESSES")
    env_pid = os.environ.get("JAX_PROCESS_ID")
    if num_processes is None and env_np is not None:
        num_processes = int(env_np)
    if process_id is None and env_pid is not None:
        process_id = int(env_pid)
    import jax
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def is_primary() -> bool:
    """True on the process that should write output files (process 0)."""
    import jax
    return jax.process_index() == 0


def local_device_slice(n_global_rows: int) -> slice:
    """Row range of the user axis owned by this host's devices, assuming
    the 1-D mesh enumerates devices in jax.devices() order (process-major).
    Used by the data loader to read only this host's user shard."""
    import jax
    per = n_global_rows // jax.process_count()
    p = jax.process_index()
    lo = p * per
    hi = n_global_rows if p == jax.process_count() - 1 else lo + per
    return slice(lo, hi)


def host_user_rows(n: int, ndev: Optional[int] = None) -> slice:
    """Seq-id training rows THIS host should ingest, for
    data.ratings.load_dataset(user_rows=host_user_rows): the user axis
    padded to a device multiple, partitioned process-major — the same
    row partition parallel.sharded.build_sharded_run derives, so a store
    holding only these rows feeds exactly this host's shards.

    Pass as the callable itself (it takes the ACTUAL user count, known
    only after the global id remap).
    """
    import jax
    ndev = ndev or jax.device_count()
    n_padded = -(-n // ndev) * ndev
    return local_device_slice(n_padded)
