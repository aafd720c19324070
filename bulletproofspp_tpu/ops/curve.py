"""Batched secp256k1 group law with COMPLETE projective formulas.

The reference uses branchy Jacobian formulas with explicit identity /
doubling case analysis (reference: src/Commitment.hs:118-176 ``nrmlAdd``,
and the external elliptic-curve package).  Data-dependent branches do not
vectorize, so this module re-designs the group law around the
Renes–Costello–Batina complete addition formulas for short Weierstrass
curves with a = 0 (homogeneous projective (X:Y:Z), identity (0:1:0)):
one branchless instruction stream handles P+Q, P+P, P+(-P), P+O and O+Q
uniformly — the vectorized replacement for the reference's zero checks.

Points are tuples ``(X, Y, Z)`` of limb planes (see ops.limb), batched over
trailing axes.  b = 7, b3 = 3b = 21.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from . import limb
from ..core import ec
from ..core.fields import Q

B3 = 21


def identity(batch):
    """The point at infinity (0 : 1 : 0)."""
    return limb.zeros(batch), limb.ones(batch), limb.zeros(batch)


@jax.jit
def padd(p, q):
    """Complete projective addition (RCB 2015, Algorithm 7 for a = 0).

    12 field muls (2 by the tiny constant b3); no branches; valid for all
    inputs on the curve including the identity and equal/opposite points.
    """
    x1, y1, z1 = p
    x2, y2, z2 = q
    m, a, s = limb.mul, limb.add, limb.sub

    t0 = m(x1, x2)
    t1 = m(y1, y2)
    t2 = m(z1, z2)
    t3 = s(m(a(x1, y1), a(x2, y2)), a(t0, t1))  # X1Y2 + X2Y1
    t4 = s(m(a(y1, z1), a(y2, z2)), a(t1, t2))  # Y1Z2 + Y2Z1
    t5 = s(m(a(x1, z1), a(x2, z2)), a(t0, t2))  # X1Z2 + X2Z1
    t0_3 = a(a(t0, t0), t0)  # 3 X1X2
    t2b = limb.mul_small(t2, B3)
    z3t = a(t1, t2b)
    t1m = s(t1, t2b)
    y3b = limb.mul_small(t5, B3)
    x3 = s(m(t3, t1m), m(t4, y3b))
    y3 = a(m(y3b, t0_3), m(t1m, z3t))
    z3 = a(m(z3t, t4), m(t0_3, t3))
    return x3, y3, z3


@jax.jit
def pdbl(p):
    """Complete projective doubling (RCB 2015, Algorithm 9 for a = 0)."""
    x, y, z = p
    m, a, s = limb.mul, limb.add, limb.sub

    t0 = m(y, y)
    z3 = a(t0, t0)
    z3 = a(z3, z3)
    z3 = a(z3, z3)  # 8Y^2
    t1 = m(y, z)
    t2 = limb.mul_small(m(z, z), B3)
    x3 = m(t2, z3)
    y3 = a(t0, t2)
    z3 = m(t1, z3)
    t1 = a(t2, t2)
    t2 = a(t1, t2)
    t0 = s(t0, t2)
    y3 = a(x3, m(t0, y3))
    x3 = m(t0, m(x, y))
    x3 = a(x3, x3)
    return x3, y3, z3


@jax.jit
def pneg(p):
    x, y, z = p
    return x, limb.sub(limb.zeros(y.shape[1:]), y), z


def pselect(mask, p, q):
    """Per-lane select: mask ? p : q (mask over batch axes)."""
    return tuple(limb.select(mask, a, b) for a, b in zip(p, q))


def is_identity(p):
    return limb.is_zero(p[2])


# ---------------------------------------------------------------------------
# Host <-> device conversion
# ---------------------------------------------------------------------------


def from_affine_host(points):
    """list of affine (x, y) tuples / None -> projective limb planes (host).

    None (identity) becomes (0 : 1 : 0)."""
    xs, ys, zs = [], [], []
    for pt in points:
        if pt is None:
            xs.append(0), ys.append(1), zs.append(0)
        else:
            xs.append(pt[0] % Q), ys.append(pt[1] % Q), zs.append(1)
    return (
        jnp.asarray(limb.pack_ints(xs)),
        jnp.asarray(limb.pack_ints(ys)),
        jnp.asarray(limb.pack_ints(zs)),
    )


@jax.jit
def _normalize3(x, y, z):
    return jnp.stack([limb.normalize(x), limb.normalize(y), limb.normalize(z)])


def to_affine_host(p):
    """Projective limb planes -> list of affine tuples / None (host, exact).

    Uses ONE Python modular inverse per lane; for large batches prefer
    ``to_affine`` (device batch inversion) and convert the result.
    ONE device dispatch + ONE host transfer for all three coordinates.
    """
    return affine_from_normalized(np.asarray(_normalize3(*p)))


def affine_from_normalized(arr):
    """Host tail of ``to_affine_host``: a fetched (3, 16, K) canonical
    projective array -> list of affine tuples / None (one Python modular
    inverse per lane)."""
    X = limb.unpack_ints(arr[0])
    Y = limb.unpack_ints(arr[1])
    Z = limb.unpack_ints(arr[2])
    out = []
    for x, y, z in zip(X, Y, Z):
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, Q)
            out.append((x * zi % Q, y * zi % Q))
    return out


def to_affine(p):
    """Device-side normalization: returns (x, y, inf_mask) with one batched
    inversion (the device analog of the reference's batch normalization,
    reference: src/Commitment.hs:118-127)."""
    x, y, z = p
    zi = limb.batch_inv(z)
    return limb.normalize(limb.mul(x, zi)), limb.normalize(limb.mul(y, zi)), limb.is_zero(z)


def affine_lanes_to_host(xn, yn, inf):
    xs = limb.unpack_ints(np.asarray(xn))
    ys = limb.unpack_ints(np.asarray(yn))
    infs = np.asarray(inf)
    return [None if i else (x, y) for x, y, i in zip(xs, ys, infs)]


# ---------------------------------------------------------------------------
# Kernel choice: the CUDA complete addition (ops.padd_cuda) on the GPU, the
# XLA bodies above on the CPU, which is where the tests run.
# ---------------------------------------------------------------------------


def use_padd_kernel() -> bool:
    """Whether ``padd_auto``/``pdbl_auto`` run the CUDA kernel, from JAX's
    default backend: ``"gpu"`` yes, ``"cpu"`` no, anything else is an
    error."""
    backend = jax.default_backend()
    if backend == "gpu":
        return True
    if backend == "cpu":
        return False
    raise RuntimeError(
        f"unsupported JAX backend {backend!r}: this system runs on an NVIDIA GPU "
        f"(or on the CPU for tests)"
    )


def padd_auto(p, q):
    """Complete addition over points batched on any trailing axes: the
    CUDA kernel on the GPU, ``padd`` on the CPU."""
    if not use_padd_kernel():
        return padd(p, q)
    from . import padd_cuda

    return padd_cuda.padd(p, q)


def pdbl_auto(p):
    """Doubling: on the GPU the complete addition P + P through the CUDA
    kernel (one compiled kernel instead of an XLA doubling body in every
    program), ``pdbl`` on the CPU."""
    if not use_padd_kernel():
        return pdbl(p)
    return padd_auto(p, p)


@jax.jit
def decompress_kernel(x, sign):
    """Batched point decompression: x (16, L) canonical coordinates,
    sign (L,) uint32 {0,1} = transmitted "y is the larger root" bits.

    Returns (y, ok): y (16, L) canonical with the sign-selected root, ok
    (L,) bool = x**3 + 7 was a quadratic residue.  One fused Fermat-chain
    sqrt over all lanes — the device equivalent of per-point host
    decompression (reference: src/Encoding.hs:96-103 fromXWithSign +
    src/Data/Field/Galois/FastPrime.hs:213-218 fastSqrt).
    """
    seven = limb.zeros(x.shape[1:]).at[0].set(7)
    v = limb.add(limb.mul(limb.mul(x, x), x), seven)
    r = limb.sqrt_candidate(v)
    ok = limb.eq(limb.mul(r, r), v)
    rn = limb.normalize(r)
    nn = limb.normalize(limb.sub(limb.zeros(x.shape[1:]), r))
    big = limb.gt(rn, nn)  # yInt > negYInt (reference: Encoding.hs:113-118)
    y = limb.select(big == (sign > 0), rn, nn)
    return y, ok


# GLV endomorphism phi(x,y,z) = (beta*x, y, z) (reference: src/Data/Curve/CM.hs:25-33)
_BETA = limb.pack_int(ec.BETA)  # numpy: lifted as a jit constant


@jax.jit
def endo(p):
    x, y, z = p
    beta = jnp.asarray(_BETA).reshape(limb.NLIMB, *([1] * (x.ndim - 1)))
    return limb.mul(x, jnp.broadcast_to(beta, x.shape)), y, z
