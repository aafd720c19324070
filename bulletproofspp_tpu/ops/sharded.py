"""Multi-chip sharded MSM over a jax.sharding.Mesh.

The reference is a single OS process; its only distribution hooks are the
multiparty dealer stubs that sum per-party commitment vectors
(reference: src/ZKP.hs:114-131).  This framework makes the MSM itself
the distributed object (SURVEY §2 parallelism mapping):

  * mesh axis ``pts``  — data parallelism over MSM lanes (the DP analog):
    each device builds tables and accumulates digit rows for its slice of
    the points;
  * mesh axis ``win``  — parallelism over digit-row windows (the TP
    analog): each device processes a contiguous block of signed-digit rows
    and the partial results are Horner-combined with the appropriate
    doubling shifts.

Partial results are exchanged with ``lax.all_gather`` (NCCL over NVLink
on the GPU) and reduced
with complete point additions on every device (point addition is a group
op, not a ring sum, so ``psum`` does not apply — the gather+fold IS the
collective).  The result is replicated.

Used by batch verification (core.batch) through ShardedJaxEngine.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from . import curve, limb
from .msm import msm_kernel


def make_mesh(devices=None, win: int = 1):
    """1- or 2-axis mesh ('win', 'pts') over the given devices."""
    import numpy as np

    devices = list(jax.devices()) if devices is None else list(devices)
    n = len(devices)
    if n % win != 0:
        raise ValueError(f"device count {n} not divisible by win={win}")
    npts = n // win
    if npts & (npts - 1):
        raise ValueError(
            f"'pts' axis size {npts} must be a power of two: sharded_msm "
            f"splits the (power-of-two) padded lane bucket evenly across "
            f"point shards.  Use a win factor that leaves a power-of-two "
            f"pts axis, or drop extra devices."
        )
    arr = np.asarray(devices).reshape(win, npts)
    return Mesh(arr, ("win", "pts"))


def pad_rows(absd, sgn, win: int):
    """Pad digit rows on the most-significant side (zero digits are
    no-ops) so the row count divides the window axis."""
    rows = absd.shape[0]
    target = -(-rows // win) * win
    pad = target - rows
    if pad:
        z = jnp.zeros((pad, absd.shape[1]), absd.dtype)
        absd = jnp.concatenate([z, absd], axis=0)
        sgn = jnp.concatenate([z, sgn], axis=0)
    return absd, sgn


def sharded_msm(mesh: Mesh, px, py, pz, absd, sgn):
    """MSM sharded over ('win', 'pts'); returns replicated projective
    (16, 1) coordinate planes.

    Lane count must divide the 'pts' axis with a power-of-two quotient;
    row count must divide the 'win' axis (see pad_rows).
    """
    nwin = mesh.shape["win"]
    npts = mesh.shape["pts"]
    rows_local = absd.shape[0] // nwin

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, "pts"), P(None, "pts"), P(None, "pts"), P("win", "pts"), P("win", "pts")),
        out_specs=(P(), P(), P()),
        # the gather+fold produces bit-identical values on every device;
        # that replication is data-flow equality the static VMA checker
        # cannot see, so the check is disabled for this kernel
        check_vma=False,
    )
    def step(pxl, pyl, pzl, absdl, sgnl):
        from .msm import _reduce_lanes

        part = msm_kernel(pxl, pyl, pzl, absdl, sgnl)  # local rows x local lanes

        # combine over point shards: gather + fold (group op, not psum)
        gath = tuple(
            jnp.moveaxis(lax.all_gather(c[..., 0], "pts"), 0, -1) for c in part
        )  # (16, npts)
        acc = tuple(g[..., :1] for g in _reduce_lanes(gath, npts))

        # combine over window shards: Horner with 4*rows_local doublings
        gw = tuple(lax.all_gather(c, "win") for c in acc)  # (nwin, 16, 1)

        def horner(tot, w):
            tot = lax.scan(
                lambda a, _: (curve.pdbl_auto(a), None), tot, None, length=4 * rows_local
            )[0]
            return curve.padd_auto(tot, tuple(g[w] for g in gw)), None

        tot = tuple(g[0] for g in gw)
        if nwin > 1:
            tot, _ = lax.scan(horner, tot, jnp.arange(1, nwin))
        return tot

    return step(px, py, pz, absd, sgn)


def sharded_msm_jit(mesh: Mesh):
    return jax.jit(partial(sharded_msm, mesh))
