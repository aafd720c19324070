"""Multi-host runtime skeleton.

The reference is a single OS process (SURVEY §5: "Distributed
communication backend: none").  This module supplies the multi-process
equivalent: a ``jax.distributed`` entry point, global mesh
construction over every process's devices, and global-array placement
helpers so the sharded MSM (ops.sharded) runs unchanged across process
boundaries.  Fiat-Shamir stays host-replicated — every process computes
identical challenges from identical transcripts, so the only cross-host
traffic is the MSM's own gather/fold collective (SURVEY §5 mapping).

Tested without a cluster by tests/test_multihost.py: two local processes
with 4 virtual CPU devices each form one 8-device global mesh and run
the sharded MSM across the process boundary (SURVEY §4 "multi-node
testing without a cluster").
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P


def initialize_from_env() -> bool:
    """Join a multi-process JAX runtime if BPPP_COORDINATOR is set
    (format host:port, with BPPP_NUM_PROCS / BPPP_PROC_ID); returns
    whether distributed mode is active.  Call before any jax use."""
    coord = os.environ.get("BPPP_COORDINATOR")
    if not coord:
        return False
    # NOTE: set BPPP_NO_COMPILE_CACHE=1 in every process of a
    # multi-process run BEFORE importing bulletproofspp_tpu.ops — a
    # shared persistent compile cache lets one process load a cached
    # executable while a peer compiles, skewing collective setup until
    # the shutdown barrier times out (observed with the CPU Gloo
    # backend).
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(os.environ["BPPP_NUM_PROCS"]),
        process_id=int(os.environ["BPPP_PROC_ID"]),
    )
    return True


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def global_mesh(win: int = 1):
    """('win', 'pts') mesh over ALL processes' devices.  Device order is
    jax.devices() (process-major) reshaped to (win, n/win): with win=1
    the 'pts' axis spans processes (point-shard gather rides DCN); with
    win = process_count the 'win' axis spans processes instead.  Pick by
    which collective should cross hosts."""
    from . import sharded

    return sharded.make_mesh(jax.devices(), win=win)


def place_replicated_host_data(mesh, spec, host_array):
    """Build a global array for ``mesh`` from host data that every
    process holds IDENTICALLY (the deterministic-transcript invariant:
    scalars/digits/points are derived from the same transcript on every
    host, so no data needs to move — each process donates its local
    shards from its own copy)."""
    host_array = np.asarray(host_array)
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(host_array.shape, sharding, lambda idx: host_array[idx])


def fetch_replicated(global_array) -> np.ndarray:
    """Host value of a fully-replicated global array (every process holds
    a full copy among its addressable shards)."""
    shards = global_array.addressable_shards
    if not shards:
        raise ValueError("no addressable shard")
    # out_specs=P() replication: every device's shard is the full value
    return np.asarray(shards[0].data)


# one jitted step per mesh: rebuilding jax.jit(partial(...)) per call
# would retrace+relower the whole sharded MSM every time
_STEP_CACHE: dict = {}


def sharded_msm_step(mesh):
    step = _STEP_CACHE.get(mesh)
    if step is None:
        from . import sharded

        step = _STEP_CACHE[mesh] = sharded.sharded_msm_jit(mesh)
    return step


# the sharded MSM's input layout (ops/sharded.py in_specs): point coords
# are data-parallel over 'pts', digit rows over ('win', 'pts')
MSM_SPECS = (P(None, "pts"), P(None, "pts"), P(None, "pts"), P("win", "pts"), P("win", "pts"))


def run_global(mesh, step, px, py, pz, absd, sgn):
    """Run a jitted sharded-MSM step with multi-process placement: host
    inputs (replicated on every process) -> global arrays laid out per
    MSM_SPECS -> one jit across the global mesh -> replicated result
    fetched locally.  The ONE placement implementation — used by both
    sharded_msm_global and ShardedJaxEngine.msm."""
    args = [
        place_replicated_host_data(mesh, sp, a)
        for sp, a in zip(MSM_SPECS, (px, py, pz, absd, sgn))
    ]
    return tuple(fetch_replicated(c) for c in step(*args))


def sharded_msm_global(mesh, px, py, pz, absd, sgn):
    """ops.sharded.sharded_msm with multi-process placement.
    Single-process meshes skip the placement."""
    import jax.numpy as jnp

    step = sharded_msm_step(mesh)
    if not is_multiprocess():
        out = step(
            jnp.asarray(px), jnp.asarray(py), jnp.asarray(pz), jnp.asarray(absd), jnp.asarray(sgn)
        )
        return tuple(np.asarray(c) for c in out)
    return run_global(mesh, step, px, py, pz, absd, sgn)
