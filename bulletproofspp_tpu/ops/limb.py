"""Batched secp256k1 base-field arithmetic on 16x16-bit limb planes.

The reference implements Fq as hand-rolled 4x64-bit limb arithmetic with a
sparse-prime reduction (reference: src/Data/Field/Galois/FastPrime/Internal.hs:
mulField# 939-973, addField# 903-924, invField# 977-983).  This module
re-designs the same math as 32-bit vector work: a field element is 16
limbs of 16 bits stored in ``uint32`` planes with the **limb axis
leading** — an element batch is an array of shape ``(16, ...)`` so that
every limb op vectorizes over the trailing batch axes, and every limb
product fits a ``uint32`` exactly.

Key invariants:
  * inputs/outputs of every public op are "carried" limb arrays: each limb
    < 2^16, total value < 2^256 (representatives may exceed the prime p;
    ``normalize`` produces the canonical value < p).
  * all intermediate products fit uint32 exactly: 16-bit limb products are
    < 2^32, and partial-product columns are split into lo/hi 16-bit halves
    *before* accumulation.
  * reduction mod p = 2^256 - C (C = 2^32 + 977) mirrors the reference's
    chained short multiplications by the sparse offset
    (reference: Internal.hs:939-973): fold hi*C into the low 256 bits a
    statically-bounded number of times.

Everything here is shape-polymorphic in the trailing batch axes and safe to
trace under ``jax.jit`` / ``lax.scan`` / ``shard_map``.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..core.fields import Q

NLIMB = 16
LBITS = 16
MASK = (1 << LBITS) - 1

# p = 2^256 - C with C = 2^32 + 977  (reference: Internal.hs prime structure)
C_LOW = 977
assert Q == (1 << 256) - ((1 << 32) + C_LOW)

U32 = jnp.uint32


def _u(x):
    return jnp.asarray(x, U32)


# ---------------------------------------------------------------------------
# Host <-> limb conversion (numpy; exact Python ints)
# ---------------------------------------------------------------------------


def pack_ints(vals) -> np.ndarray:
    """list[int] (< 2^256) -> (16, n) uint32 limb array."""
    n = len(vals)
    out = np.zeros((NLIMB, n), np.uint32)
    for j, v in enumerate(vals):
        out[:, j] = np.frombuffer(int(v).to_bytes(32, "little"), dtype="<u2")
    return out


def unpack_ints(arr) -> list:
    """(16, n) limb array -> list[int]."""
    a = np.asarray(arr, np.uint32).astype("<u2")
    return [int.from_bytes(a[:, j].tobytes(), "little") for j in range(a.shape[1])]


def pack_int(v: int) -> np.ndarray:
    return pack_ints([v])[:, 0]


def unpack_int(arr) -> int:
    return unpack_ints(np.asarray(arr).reshape(NLIMB, 1))[0]


def zeros(batch) -> jnp.ndarray:
    return jnp.zeros((NLIMB, *batch), U32)


def ones(batch) -> jnp.ndarray:
    return zeros(batch).at[0].set(1)


# ---------------------------------------------------------------------------
# Carry propagation / reduction folding
# ---------------------------------------------------------------------------


def _carry(x):
    """Exact carry propagation over the leading limb axis — Kogge-Stone
    parallel prefix, NO sequential scan (a ripple scan serializes ~K tiny
    steps per call and dominates MSM latency; the prefix form is log2(K)
    full-width vector ops).

    x: (K, ...) uint32 (any magnitude).  Returns (K+1, ...) limbs < 2^16
    with the same total value.

    Steps: (1) split each entry into digit+multi-bit carry and shift the
    carries up one limb — entries drop below 2^17; (2) split again —
    residual carries are single-bit; (3) resolve the single-bit ripple
    with a generate/propagate parallel prefix ((g,p) composition is
    associative), then add the incoming carries.
    """
    K = x.shape[0]

    def shift_up(h):
        # h_k -> position k+1, extending by one limb
        z = jnp.zeros_like(h[:1])
        return jnp.concatenate([z, h], axis=0)

    # pass 1: multi-bit local carries
    t = jnp.concatenate([x & MASK, jnp.zeros_like(x[:1])], axis=0) + shift_up(x >> LBITS)[: K + 1]
    # pass 2: now t < 2^17; one more split leaves single-bit carries
    t = jnp.concatenate([t & MASK, jnp.zeros_like(t[:1])], axis=0)[: K + 1] + shift_up(t >> LBITS)[: K + 1]
    # t < 2^16 + 1; generate/propagate on the (possible) +1 ripple
    d = t & MASK
    g = t >> LBITS  # in {0,1}: carry OUT of position k (before ripple)
    p = (d == MASK).astype(U32)  # propagates an incoming carry
    # Kogge-Stone: compose (g,p) over increasing strides; after full
    # composition, g_k = carry INTO position k+1
    stride = 1
    n = K + 1
    while stride < n:
        gs = jnp.concatenate([jnp.zeros_like(g[:stride]), g[:-stride]], axis=0)
        ps = jnp.concatenate([jnp.zeros_like(p[:stride]), p[:-stride]], axis=0)
        g = g | (p & gs)
        p = p & ps
        stride *= 2
    carry_in = jnp.concatenate([jnp.zeros_like(g[:1]), g[:-1]], axis=0)
    return (d + carry_in) & MASK


def _fold_once(x):
    """Fold limbs >= 16 back into the low 256 bits via *C = 2^32 + 977.

    x: (K, ...) carried limbs (< 2^16).  Returns carried limbs of shape
    (K', ...) with K' = max(16, K-16+2) + 1.  Value is reduced mod p.
    """
    K = x.shape[0]
    if K <= NLIMB:
        return x
    lo, hi = x[:NLIMB], x[NLIMB:]
    h = hi.shape[0]
    ncols = max(NLIMB, h + 2)
    # build t from lo directly (a FULL-axis .at[...].add lowers to a
    # scatter that captures empty index constants, which Pallas kernels
    # reject); the remaining updates are strictly partial slices
    if ncols > NLIMB:
        t = jnp.concatenate([lo, jnp.zeros((ncols - NLIMB, *x.shape[1:]), U32)], axis=0)
    else:
        t = lo
    # hi * 977  (each product < 2^26)
    t = t.at[:h].add(hi * _u(C_LOW))
    # hi << 32  (two limbs up)
    t = t.at[2 : h + 2].add(hi)
    return _carry(t)


def _fold_full(x, n_folds: int):
    for _ in range(n_folds):
        x = _fold_once(x)
    return x[:NLIMB]


def _lazy_fold(x):
    """_fold_once WITHOUT the carry pass: fold limbs >= 16 into the low
    part, leaving lazy (un-carried) limbs.  Callers must prove the uint32
    bound: each output limb < input_limb_bound * 979 (+ prior lazies)."""
    K = x.shape[0]
    if K <= NLIMB:
        return x
    lo, hi = x[:NLIMB], x[NLIMB:]
    h = K - NLIMB
    ncols = max(NLIMB, h + 2)
    if ncols > NLIMB:
        t = jnp.concatenate([lo, jnp.zeros((ncols - NLIMB, *x.shape[1:]), U32)], axis=0)
    else:
        t = lo
    t = t.at[:h].add(hi * _u(C_LOW))
    t = t.at[2 : h + 2].add(hi)
    return t


def _fold_tail(c):
    """Final reduction of a CARRIED (17, ...) value known to be
    < 2^256 + 2^80: the top limb o is {0,1} and, when o = 1, the low part
    is < 2^80 (limbs >= 5 are zero).  Folding o*C therefore ripples only
    within the first 6 limbs — one cheap 6-limb carry instead of a full
    pass.  Returns (16, ...) fully carried limbs < 2^256."""
    o = c[NLIMB : NLIMB + 1]
    zero1 = jnp.zeros_like(o)
    extra = jnp.concatenate([o * _u(C_LOW), zero1, o, zero1, zero1, zero1], axis=0)
    head = _carry(c[:6] + extra)  # (7, ...): top row provably 0
    return jnp.concatenate([head[:6], c[6:NLIMB]], axis=0)


# ---------------------------------------------------------------------------
# Ring ops
# ---------------------------------------------------------------------------


def _fold_top_lazy(c, top_bound_pow: int):
    """Fold a carried (17, ...) value's top limb as a LAZY add of top*C
    (no carry); caller feeds the result to one more _carry.  Valid while
    977*top + prior limb values stay < 2^32 (top < 2^{top_bound_pow})."""
    assert 10 + top_bound_pow < 32
    o = c[NLIMB : NLIMB + 1]
    zero1 = jnp.zeros_like(o)
    extra = jnp.concatenate(
        [o * _u(C_LOW), zero1, o] + [zero1] * (NLIMB - 3), axis=0
    )
    return c[:NLIMB] + extra


@jax.jit
def add(a, b):
    """a + b mod p; carried-limb in, carried-limb out (< 2^256).

    Chain: one full carry (top in {0,1}), lazy top-fold, one full carry
    (top in {0,1} with a tiny low part), 6-limb tail fold.  Two full
    Kogge-Stone passes instead of three.
    """
    c1 = _carry(a + b)
    c2 = _carry(_fold_top_lazy(c1, 2))
    return _fold_tail(c2)


# limbs of 2p - 2^256 + 1 (so that a + ~b + K2 == a - b + 2p); kept as
# numpy so jit traces lift it as a constant without leaking tracers
_K2 = None


def _k2():
    global _K2
    if _K2 is None:
        _K2 = pack_int(2 * Q - (1 << 256) + 1)
    return _K2


@jax.jit
def sub(a, b):
    """a - b mod p, computed as the always-nonnegative a + (~b) + K2 where
    ~b is the borrow-free limbwise complement (0xffff - b) and
    K2 = 2p - 2^256 + 1; the 2p offset folds away in reduction.

    (the reference reduces on borrow by the sparse offset the same way,
    reference: Internal.hs subField#)
    """
    _K2 = jnp.asarray(_k2(), U32)
    w = _u(MASK) - b  # exact: b limbs < 2^16
    k2 = _K2.reshape(NLIMB, *([1] * (a.ndim - 1)))
    c1 = _carry(a + w + k2)  # value a - b + 2p < 3*2^256: top limb <= 2
    c2 = _carry(_fold_top_lazy(c1, 2))
    return _fold_tail(c2)


def neg(a):
    return sub(zeros(a.shape[1:]), a)


@jax.jit
def mul(a, b):
    """a * b mod p.  Schoolbook 16x16 outer product, lo/hi split before
    column accumulation, shear-trick antidiagonal sums, scan carries, and
    4 statically-bounded reduction folds (value analysis in module docs).
    """
    batch = a.shape[1:]
    # outer products: (16, 16, ...) exact in uint32
    prods = a[:, None] * b[None, :]
    lo = prods & MASK
    hi = prods >> LBITS

    def shear(x):
        # x: (16, 16, ...) -> column sums (31, ...) where col k = sum_{i+j=k}
        xp = jnp.pad(x, [(0, 0), (0, NLIMB)] + [(0, 0)] * len(batch))
        flat = xp.reshape(NLIMB * 2 * NLIMB, *batch)
        flat = flat[: NLIMB * (2 * NLIMB - 1)]
        return flat.reshape(NLIMB, 2 * NLIMB - 1, *batch).sum(axis=0, dtype=U32)

    cols_lo = shear(lo)  # columns 0..30, each < 16*2^16 = 2^20
    cols_hi = shear(hi)  # contributes to columns 1..31
    cols = jnp.zeros((2 * NLIMB, *batch), U32)
    cols = cols.at[: 2 * NLIMB - 1].add(cols_lo)
    cols = cols.at[1 : 2 * NLIMB].add(cols_hi)
    # BOTH reduction folds run lazily on un-carried columns (cols < 2^21,
    # so two stacked folds stay < 2*979*2^21 < 2^32).  Worst-case column
    # analysis: 16 un-carried limbs each < 2*979*2^21 bound the VALUE by
    # 16 * 2*979*2^21 * 2^240 < 2^272, so after the first full carry the
    # top limb is < 2^16 with ARBITRARY low limbs — _fold_tail's 6-limb
    # window is only exact for top in {0,1} with a tiny low part (a
    # saturated-0xFFFF run would silently drop a 2^96 carry; found by an
    # adversarial sqrt chain, pinned in tests/test_ops_limb.py).  One
    # more lazy top-fold + full carry brings the value below
    # 2^256 + 977*2^16 < 2^256 + 2^48 (top in {0,1}, limbs >= 4 of the
    # overflow zero), well inside _fold_tail's 2^256 + 2^80 precondition.
    t1 = _lazy_fold(cols)  # 18 lazy limbs < 979*2^21
    t2 = _lazy_fold(t1)  # 16 lazy limbs < 2*979*2^21
    c = _carry(t2)  # exact; top limb < 2^16
    t3 = _fold_top_lazy(c, 16)  # value < 2^256 + 2^48
    return _fold_tail(_carry(t3))


def sqr(a):
    return mul(a, a)


from functools import partial


@partial(jax.jit, static_argnums=1)
def mul_small(a, k: int):
    """a * k mod p for a small host constant 0 <= k < 2^15."""
    c1 = _carry(a * _u(k))  # top limb < 2^15
    c2 = _carry(_fold_top_lazy(c1, 15))
    return _fold_tail(c2)


@jax.jit
def normalize(a):
    """Canonical representative < p (conditional subtract of p).

    Inputs are < 2^256 and 2^256 - p = C is tiny, so one conditional
    subtraction suffices (reference: Internal.hs:903-924 reduces the same
    way on compare).
    """
    p_limbs = jnp.asarray(pack_int(Q), U32).reshape(NLIMB, *([1] * (a.ndim - 1)))

    def step(borrow, ab):
        av, pv = ab
        t = av - pv - borrow
        return t >> 31, t & MASK  # borrow iff wrapped negative (values < 2^17)

    borrow, outs = lax.scan(
        step, jnp.zeros_like(a[0]), (a, jnp.broadcast_to(p_limbs, a.shape))
    )
    # borrow == 0 means a >= p: take the subtracted value
    return jnp.where(borrow[None] == 0, outs, a)


@jax.jit
def is_zero(a):
    """Boolean mask over the batch axes: a ≡ 0 mod p."""
    n = normalize(a)
    return jnp.all(n == 0, axis=0)


@jax.jit
def eq(a, b):
    return is_zero(sub(a, b))


def select(mask, a, b):
    """Elementwise select over batch axes: mask ? a : b (mask: batch-shaped bool)."""
    return jnp.where(mask[None], a, b)


# ---------------------------------------------------------------------------
# Inversion
# ---------------------------------------------------------------------------

_INV_EXP_BITS = np.array(
    [(Q - 2) >> i & 1 for i in range(255, -1, -1)], dtype=np.uint32
)


@jax.jit
def inv(a):
    """Fermat inverse a^(p-2); 0 -> 0.  (The reference calls GMP's
    recipModBigNat, reference: Internal.hs:977-983; on the device a fixed
    square-and-multiply scan keeps shapes static.)"""
    bits = jnp.asarray(_INV_EXP_BITS)

    def step(r, bit):
        r2 = mul(r, r)
        rm = mul(r2, a)
        return jnp.where(bit > 0, rm, r2), None

    r, _ = lax.scan(step, ones(a.shape[1:]), bits)
    return r


_SQRT_EXP_BITS = np.array(
    [((Q + 1) // 4) >> i & 1 for i in range(253, -1, -1)], dtype=np.uint32
)


@jax.jit
def sqrt_candidate(a):
    """a^((p+1)/4) — THE principal square root when a is a QR (p = 3 mod
    4; callers must check sqr(r) == a to detect non-residues).  Device
    equivalent of the reference's fastSqrt
    (reference: src/Data/Field/Galois/FastPrime.hs:213-218)."""
    bits = jnp.asarray(_SQRT_EXP_BITS)

    def step(r, bit):
        r2 = mul(r, r)
        rm = mul(r2, a)
        return jnp.where(bit > 0, rm, r2), None

    r, _ = lax.scan(step, ones(a.shape[1:]), bits)
    return r


@jax.jit
def gt(a, b):
    """Boolean mask over batch axes: a > b as 256-bit integers (inputs
    carried limbs; compared as raw representatives, so normalize first
    for canonical comparison)."""

    def step(borrow, ab):
        av, bv = ab
        t = bv - av - borrow
        return t >> 31, None

    borrow, _ = lax.scan(step, jnp.zeros_like(a[0]), (a, b))
    return borrow > 0  # b - a underflowed => a > b


@partial(jax.jit, static_argnums=1)
def batch_inv(a, axis=1):
    """Montgomery batch inversion along a batch axis with ONE Fermat inverse.

    Parallel-scan formulation: inv_i = exclusive_prefix_i * T * exclusive_suffix_i
    with T = inv(total product).  Zeros map to zero
    (reference: src/Data/Field/BatchInverse.hs:14-24; the sequential scan is
    re-designed as two ``associative_scan``s — the SP analog per SURVEY §2).
    """
    zmask = is_zero(a)
    ax = select(zmask, ones(a.shape[1:]), a)
    prefix = lax.associative_scan(mul, ax, axis=axis)
    suffix = lax.associative_scan(mul, ax, axis=axis, reverse=True)
    total = jnp.take(prefix, a.shape[axis] - 1, axis=axis)  # scanned axis dropped
    t = jnp.expand_dims(inv(total), axis)
    # exclusive prefix/suffix: shift by one along axis, fill with field 1
    exc_pre = _shift(prefix, axis, 1, fill_one=True)
    exc_suf = _shift(suffix, axis, -1, fill_one=True)
    out = mul(mul(exc_pre, t), exc_suf)
    return select(zmask, zeros(a.shape[1:]), out)


def _shift(x, axis, by, fill_one=False):
    """Shift along ``axis`` by ``by`` (positive: toward higher idx), filling
    vacated slots with the field value 1."""
    fill = jnp.zeros_like(lax.slice_in_dim(x, 0, abs(by), axis=axis))
    fill = fill.at[0].set(1) if fill_one else fill
    n = x.shape[axis]
    if by > 0:
        body = lax.slice_in_dim(x, 0, n - by, axis=axis)
        return lax.concatenate([fill, body], dimension=axis)
    else:
        body = lax.slice_in_dim(x, -by, n, axis=axis)
        return lax.concatenate([body, fill], dimension=axis)
