"""Vectorized multi-scalar multiplication kernels.

Re-design of the reference's row-serial Straus MSM
(reference: src/Commitment.hs:311-398 ``FastInnerProduct.innerProduct``)
as fixed-shape batched device work:

  * scalars are GLV-split on host (ops.glv) into two ~sqrt(n) halves, so a
    k*P lane becomes two lanes (P, phi(P)) — same trick as the reference's
    129-row Eisenstein digit MSM, but with 4-bit signed digits and 33 rows;
  * per lane, a 9-entry multiple table [0P..8P] is built with 7 batched
    complete additions (ops.curve.padd_auto — branchless, identity-safe);
  * digit selection is ONE-HOT masked accumulation; signs select from a
    pre-negated table (no data-dependent control flow anywhere);
  * the row×lane selected points are tree-reduced over lanes (log2 L
    batched adds — the per-row reduction the reference does serially), and
    the 33 row sums are Horner-combined under ``lax.scan``.

Work: ~L*(33 + 8) complete adds per MSM of L lanes — Pippenger-class for
the proof-sized MSMs here, with zero data-dependent shapes.

``fold_mul_kernel`` covers both per-round basis folding b*G_even + a*G_odd
(reference: src/Commitment.hs:343-353 ``projectivePairIP``) and shared
scalar multiplication (square-completion transform, reference:
src/Bulletproof/InnerProductArgument.hs:194-206): both are "two shared
digit streams against two per-lane tables".
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import limb, curve
from .glv import ROWS

U32 = jnp.uint32


def _table(px, py, pz):
    """Projective lanes (16, L) -> multiple tables (16, 9, L) for 0P..8P,
    plus the Y table extended with negated entries: (16, 18, L).

    Bases are PROJECTIVE (complete formulas never need affine inputs), so
    identity lanes (0:1:0) are valid pad/None encodings.  The 7 chained
    additions run under ``lax.scan`` so the complete-add body lowers ONCE
    (compile time on the XLA CPU backend scales with the number of
    inlined point ops, so every repeated op here is a scan)."""
    one = limb.ones(px.shape[1:])
    zero = limb.zeros(px.shape[1:])
    base = (px, py, pz)
    ident = (zero, one, zero)

    def step(acc, _):
        nxt = curve.padd_auto(acc, base)
        return nxt, nxt

    _, mults = lax.scan(step, base, None, length=7)  # (7, 16, L) per coord
    tx = jnp.concatenate([jnp.stack([ident[0], base[0]], 1), jnp.moveaxis(mults[0], 0, 1)], axis=1)
    ty = jnp.concatenate([jnp.stack([ident[1], base[1]], 1), jnp.moveaxis(mults[1], 0, 1)], axis=1)
    tz = jnp.concatenate([jnp.stack([ident[2], base[2]], 1), jnp.moveaxis(mults[2], 0, 1)], axis=1)
    ty2 = jnp.concatenate([ty, limb.sub(jnp.zeros_like(ty), ty)], axis=1)  # (16, 18, L)
    return tx, ty2, tz


def _reduce_lanes(sel, width):
    """Tree-reduce points over the last axis by halving: width-1 complete
    adds in log2(width) calls, so the compiled graph holds log2(width)
    additions.  Returns the reduced tuple with last axis 1."""
    assert width & (width - 1) == 0, "lane count must be a power of two"
    while width > 1:
        width //= 2
        sel = curve.padd_auto(tuple(t[..., :width] for t in sel), tuple(t[..., width:] for t in sel))
    return sel


def _dbl4(acc):
    """Four doublings as a scan (single doubling lowering)."""
    return lax.scan(lambda a, _: (curve.pdbl_auto(a), None), acc, None, length=4)[0]


def msm_kernel(px, py, pz, absd, sgn):
    """sum_i s_i * P_i over L lanes.

    px, py, pz: (16, L) projective lanes (GLV halves pre-expanded by the
    caller; identity lanes encode None/padding).
    absd, sgn: (ROWS, L) uint32 digit magnitudes [0..8] and signs {0,1}.
    Returns a single projective point as (16, 1) limb planes per coord.
    """
    L = px.shape[-1]
    rows = absd.shape[0]

    tx, ty2, tz = _table(px, py, pz)

    # digit selection as ONE-HOT masked accumulation: 9 (resp. 18 signed)
    # full-width masked adds, no gather
    def onehot_select(table, idx):
        n_entries = table.shape[1]
        acc = jnp.zeros((limb.NLIMB, rows, L), U32)
        for k in range(n_entries):
            mask = (idx == k)[None]  # (1, ROWS, L)
            acc = acc + jnp.where(mask, table[:, k, None, :], jnp.uint32(0))
        return acc

    idxy = absd + 9 * sgn
    selx = onehot_select(tx, absd)  # (16, ROWS, L)
    sely = onehot_select(ty2, idxy)
    selz = onehot_select(tz, absd)

    # tree-reduce over lanes (the reference's per-row serial adds,
    # reference: Commitment.hs:331-335, become log2(L) batched adds)
    sel = _reduce_lanes((selx, sely, selz), L)

    rows = tuple(jnp.moveaxis(t[..., :1], 1, 0) for t in sel)  # (ROWS, 16, 1)

    def horner(acc, row):
        return curve.padd_auto(_dbl4(acc), row), None

    # identity derived from the inputs so its sharding/varying-axes type
    # matches the scan body output under shard_map
    zero = jnp.zeros_like(rows[0][0])
    init = (zero, zero.at[0].set(1), zero)
    acc, _ = lax.scan(horner, init, rows)
    return acc


def fold_mul_kernel(pex, pey, pez, pox, poy, poz, de, se, do, so):
    """Per-lane b*E_i + a*O_i with SHARED digit streams.

    pex/pey/pez, pox/poy/poz: (16, L) projective lanes for the two bases
    (identity encodes a None base, whose contribution is the identity).
    de, se: (ROWS,) digits/signs of the scalar multiplying E lanes;
    do, so: same for O lanes.  Returns projective (16, L) coords.

    Covers basis folding (reference: src/Commitment.hs:343-353) and, with
    O = phi(E), shared scalar mult k*P via GLV halves.
    """
    tex, tey2, tez = _table(pex, pey, pez)
    tox, toy2, toz = _table(pox, poy, poz)

    def body(acc, row):
        d_e, s_e, d_o, s_o = row
        acc = _dbl4(acc)
        pe = (
            lax.dynamic_index_in_dim(tex, d_e, axis=1, keepdims=False),
            lax.dynamic_index_in_dim(tey2, d_e + 9 * s_e, axis=1, keepdims=False),
            lax.dynamic_index_in_dim(tez, d_e, axis=1, keepdims=False),
        )
        po = (
            lax.dynamic_index_in_dim(tox, d_o, axis=1, keepdims=False),
            lax.dynamic_index_in_dim(toy2, d_o + 9 * s_o, axis=1, keepdims=False),
            lax.dynamic_index_in_dim(toz, d_o, axis=1, keepdims=False),
        )
        return curve.padd_auto(curve.padd_auto(acc, pe), po), None

    xs = (de.astype(jnp.int32), se.astype(jnp.int32), do.astype(jnp.int32), so.astype(jnp.int32))
    zero = jnp.zeros_like(pex)
    init = (zero, zero.at[0].set(1), zero)  # input-derived: shard_map-safe
    acc, _ = lax.scan(body, init, xs)
    return acc


def complete_square_kernel(g0x, g0y, g0z, e0x, e0y, e0z, g1x, g1y, g1z, de, se, do, so):
    """(g1 + r*g0, g1 - r*g0) lanes where r*g0 is evaluated via GLV halves
    (g0, phi(g0)) with shared digit streams (reference:
    src/Bulletproof/InnerProductArgument.hs:194-206 square completion)."""
    rp = fold_mul_kernel(g0x, g0y, g0z, e0x, e0y, e0z, de, se, do, so)
    g1 = (g1x, g1y, g1z)
    gx = curve.padd_auto(g1, rp)
    hy = curve.padd_auto(g1, curve.pneg(rp))
    return gx + hy


_msm_compiled = jax.jit(msm_kernel)
_msm_pair_compiled = jax.jit(jax.vmap(msm_kernel))
_fold_compiled = jax.jit(fold_mul_kernel)
_fold_many_compiled = jax.jit(jax.vmap(fold_mul_kernel))
_csq_compiled = jax.jit(complete_square_kernel)


def _csq_with_endo(g0x, g0y, g0z, g1x, g1y, g1z, de, se, do, so):
    ex, ey, ez = curve.endo((g0x, g0y, g0z))
    return complete_square_kernel(g0x, g0y, g0z, ex, ey, ez, g1x, g1y, g1z, de, se, do, so)


_csq_many_compiled = jax.jit(jax.vmap(_csq_with_endo))


def run_msm(px, py, pz, absd, sgn):
    return _msm_compiled(px, py, pz, absd, sgn)


def run_fold(pex, pey, pez, pox, poy, poz, de, se, do, so):
    """fold_mul then batched normalize to affine lanes on device."""
    acc = _fold_compiled(pex, pey, pez, pox, poy, poz, de, se, do, so)
    return _to_affine_compiled(acc)


@jax.jit
def _to_affine_compiled(acc):
    return curve.to_affine(acc)
