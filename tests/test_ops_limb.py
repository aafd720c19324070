"""Limb-plane field kernels vs Python bignum ground truth."""

import random

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from bulletproofspp_tpu.core.fields import Q
from bulletproofspp_tpu.ops import limb

rng = random.Random(1234)

EDGE = [
    0,
    1,
    2,
    976,
    977,
    978,
    (1 << 32) + 977,  # C
    Q - 1,
    Q,
    Q + 1,
    (1 << 256) - 1,
    (1 << 256) - (1 << 32) - 978,
    (1 << 255),
    (1 << 128) - 1,
]
RAND = [rng.randrange(1 << 256) for _ in range(18)]
VALS = EDGE + RAND


def roundtrip(vals):
    return limb.unpack_ints(limb.pack_ints(vals))


def test_pack_roundtrip():
    assert roundtrip(VALS) == VALS


def _pairs():
    a = VALS
    b = list(reversed(VALS))
    return a, b


def test_add():
    a, b = _pairs()
    out = limb.unpack_ints(
        np.asarray(limb.normalize(limb.add(limb.pack_ints(a), limb.pack_ints(b))))
    )
    assert out == [(x + y) % Q for x, y in zip(a, b)]


def test_sub():
    a, b = _pairs()
    out = limb.unpack_ints(
        np.asarray(limb.normalize(limb.sub(limb.pack_ints(a), limb.pack_ints(b))))
    )
    assert out == [(x - y) % Q for x, y in zip(a, b)]


def test_mul():
    a, b = _pairs()
    out = limb.unpack_ints(
        np.asarray(limb.normalize(limb.mul(limb.pack_ints(a), limb.pack_ints(b))))
    )
    assert out == [(x * y) % Q for x, y in zip(a, b)]


def test_mul_small():
    a = VALS
    for k in (0, 1, 21, 977, 32767):
        out = limb.unpack_ints(
            np.asarray(limb.normalize(limb.mul_small(limb.pack_ints(a), k)))
        )
        assert out == [(x * k) % Q for x in a], k


def test_normalize_canonical():
    out = limb.unpack_ints(np.asarray(limb.normalize(limb.pack_ints(VALS))))
    assert out == [v % Q for v in VALS]


def test_is_zero():
    vals = [0, Q, 1, Q - 1, 2 * Q if 2 * Q < (1 << 256) else 0]
    mask = np.asarray(limb.is_zero(limb.pack_ints(vals)))
    assert list(mask) == [v % Q == 0 for v in vals]


def test_inv():
    vals = [v for v in VALS if v % Q != 0][:8]
    out = limb.unpack_ints(np.asarray(limb.normalize(limb.inv(limb.pack_ints(vals)))))
    assert out == [pow(v, -1, Q) for v in vals]


def test_inv_zero():
    out = limb.unpack_ints(np.asarray(limb.normalize(limb.inv(limb.pack_ints([0, Q])))))
    assert out == [0, 0]


def test_batch_inv():
    vals = [1, 5, 0, Q - 1, Q, 12345, rng.randrange(Q), rng.randrange(Q)]
    out = limb.unpack_ints(
        np.asarray(limb.normalize(limb.batch_inv(limb.pack_ints(vals))))
    )
    assert out == [pow(v, -1, Q) if v % Q else 0 for v in vals]


def test_jit_composition():
    """The ops must be jittable and composable under jit."""
    import jax

    @jax.jit
    def f(a, b):
        return limb.normalize(limb.mul(limb.add(a, b), limb.sub(a, b)))

    a, b = _pairs()
    out = limb.unpack_ints(np.asarray(f(limb.pack_ints(a), limb.pack_ints(b))))
    assert out == [((x + y) * (x - y)) % Q for x, y in zip(a, b)]


def test_gt_and_sqrt_candidate():
    import numpy as np
    import jax.numpy as jnp

    from bulletproofspp_tpu.core.fields import Q
    from bulletproofspp_tpu.ops import limb

    vals_a = [0, 1, Q - 1, 12345, 2**255, 7]
    vals_b = [0, 2, Q - 1, 12344, 2**255 - 1, Q - 7]
    a = jnp.asarray(limb.pack_ints(vals_a))
    b = jnp.asarray(limb.pack_ints(vals_b))
    got = np.asarray(limb.gt(a, b))
    want = [x > y for x, y in zip(vals_a, vals_b)]
    assert list(got) == want

    # principal sqrt: r = v^((Q+1)/4); QRs round-trip, zero -> zero
    vs = [0] + [pow(v, 2, Q) for v in (3, 5, 2**200 + 7)]
    r = limb.sqrt_candidate(jnp.asarray(limb.pack_ints(vs)))
    rn = limb.unpack_ints(np.asarray(limb.normalize(r)))
    for v, root in zip(vs, rn):
        assert pow(root, 2, Q) == v % Q
        assert root == pow(v, (Q + 1) // 4, Q)


def test_mul_dropped_carry_regression():
    """Round-2 bug: _fold_tail's 6-limb window dropped a 2^96 carry when
    the mul path's first carry produced a large top limb over saturated
    0xFFFF low limbs (hit by the sqrt Fermat chain for v=(2^200+7)^2;
    probability ~2^-80 for random inputs, but adversarially reachable).
    Pins the exact failing operand on BOTH mul implementations."""
    import numpy as np
    import jax.numpy as jnp

    from bulletproofspp_tpu.core.fields import Q
    from bulletproofspp_tpu.ops import limb

    x = 94329926858193610711403129864407773699609837703255222953893265490612872160623
    a = jnp.asarray(limb.pack_ints([x] * 8))
    got = limb.unpack_ints(np.asarray(limb.normalize(limb.mul(a, a))))
    assert got == [x * x % Q] * 8

    # the CUDA kernel's multiply (host build): its addition squares X1 = X2
    # = x in t0, so on this off-curve input it must agree with the XLA
    # polynomial exactly
    from bulletproofspp_tpu.ops import curve, padd_cuda

    p = (a, a, a)
    want = [limb.unpack_ints(np.asarray(limb.normalize(c))) for c in curve.padd(p, p)]
    got = [limb.unpack_ints(np.asarray(limb.normalize(c))) for c in padd_cuda.padd(p, p)]
    assert got == want

    # Fermat-chain stress: long square-and-multiply chains walk through
    # structured values that uncover carry-bound violations
    for base in (2**200 + 7, 3, Q - 2, 2**128 + 1):
        v = pow(base, 2, Q)
        r = limb.sqrt_candidate(jnp.asarray(limb.pack_ints([v])))
        root = limb.unpack_ints(np.asarray(limb.normalize(r)))[0]
        assert root == pow(v, (Q + 1) // 4, Q), base
