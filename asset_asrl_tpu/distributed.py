"""Multi-process execution support.

The reference is a single-process shared-memory library (MKL Pardiso
threads, `src/Solvers/PardisoInterface.h`); its multi-machine story is
"run independent problems per machine" (Jet).  Here ONE problem can be
distributed over every device of several processes: `jax.distributed`
makes every process see the global device set, a ("host", "chip") mesh
maps the segment chain over it, and `ShardedBlockKKT` runs hierarchical
substructuring — per-device local elimination, a per-process reduction,
and a Schur exchange across processes (`Solvers/kkt_sharded.py`,
SURVEY.md section 5.8, BASELINE.md:33 N>=2 hosts).  One process that
drives all the devices of one machine needs none of this: a 1-axis
`chain_mesh()` over its local devices is enough.

Usage in each process (see docs/tutorials/MultiHost.md):

    import asset_asrl_tpu as ast
    ast.distributed.initialize("10.0.0.1:8476", num_processes=2,
                               process_id=rank)
    mesh = ast.distributed.host_chip_mesh()
    phase.setKKTBackend("sharded", mesh=mesh)
    phase.optimize()                        # identical on every process
"""

from __future__ import annotations

import numpy as np

__all__ = ["initialize", "is_initialized", "host_chip_mesh", "chain_mesh"]

_initialized = False


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, local_device_ids=None):
    """Initialize multi-process JAX (idempotent).

    Pass the coordinator explicitly, e.g.
    initialize("10.0.0.1:8476", num_processes=4, process_id=rank); JAX
    auto-detects these only under a cluster manager it knows.  Call
    before any other JAX API touches the backend.
    """
    global _initialized
    if _initialized:
        return
    import jax
    kw = {}
    if coordinator_address is not None:
        kw["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kw["num_processes"] = int(num_processes)
    if process_id is not None:
        kw["process_id"] = int(process_id)
    if local_device_ids is not None:
        kw["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kw)
    _initialized = True


def is_initialized():
    return _initialized


def host_chip_mesh(host_axis="host", chip_axis="chip"):
    """Global ("host", "chip") mesh over every device of every process.

    Rows are processes, columns the process-local devices — the shape
    `ShardedBlockKKT` uses for hierarchical
    substructuring.  Works single-process too (1 x ndevices).
    """
    import jax
    from jax.sharding import Mesh
    devs = jax.devices()
    nproc = max(1, jax.process_count())
    per = len(devs) // nproc
    grid = np.array(devs[:nproc * per]).reshape(nproc, per)
    return Mesh(grid, (host_axis, chip_axis))


def chain_mesh(axis="seg"):
    """Flat 1-axis mesh over every global device (flat substructuring;
    prefer host_chip_mesh across processes)."""
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()), (axis,))
