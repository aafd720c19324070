"""Native (C++) scalar pipeline vs the pure-Python ground truth.

The native library and ops.glv may pick different (equally valid) GLV
decompositions; what must hold exactly is the reconstruction identity
digits -> k1 + k2*lambda ≡ k (mod r) and the digit-range contract."""

import random

import pytest

from bulletproofspp_tpu import native
from bulletproofspp_tpu.core.ec import LAMBDA
from bulletproofspp_tpu.core.fields import R
from bulletproofspp_tpu.ops import glv

rng = random.Random(77)



@pytest.fixture(autouse=True)
def _native_lib():
    if native.get_lib() is None:
        pytest.skip("native lib unavailable (no g++)")


def _reconstruct(absd, sgn, col):
    v = 0
    for j in range(native.ROWS):
        d = int(absd[j, col]) * (-1 if sgn[j, col] else 1)
        v = v * 16 + d
    return v


def test_native_glv_recode_reconstructs():
    scalars = [0, 1, R - 1, LAMBDA, rng.randrange(R)] + [rng.randrange(R) for _ in range(40)]
    absd, sgn = native.glv_recode_batch(scalars)
    assert absd.shape == (native.ROWS, 2 * len(scalars))
    assert int(absd.max()) <= 8
    for i, k in enumerate(scalars):
        k1 = _reconstruct(absd, sgn, 2 * i)
        k2 = _reconstruct(absd, sgn, 2 * i + 1)
        assert (k1 + k2 * LAMBDA - k) % R == 0, (i, k)
        assert abs(k1) < 1 << 132 and abs(k2) < 1 << 132


def test_native_recode_signed_matches_python():
    import numpy as np

    for v in [0, 1, -1, 8, -8, 2**129 - 1, -(2**129), rng.randrange(1 << 130)]:
        got = native.recode_signed(v)
        assert got is not None
        want = glv.recode_signed(v)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]), v


@pytest.mark.slow
def test_engine_uses_native_and_matches_host():
    """End parity: JaxEngine msm (native digits) == host engine msm."""
    from bulletproofspp_tpu.core import ec
    from bulletproofspp_tpu.core.engine import HostEngine
    from bulletproofspp_tpu.ops.engine import JaxEngine

    pts, p = [], ec.G
    for _ in range(6):
        pts.append(p)
        p = ec.dbl(p)
    pairs = [(rng.randrange(R), q) for q in pts]
    pairs = [(s, q) for s, q in zip([s for s, _ in pairs], pts)]
    want = HostEngine().msm(pairs)
    got = JaxEngine(host_below=0).msm(pairs)
    assert got == want


@pytest.mark.slow
def test_msm_pair_and_many_match_host():
    """The fused multi-MSM dispatches must agree with the host engine."""
    import random as _r

    from bulletproofspp_tpu.core import ec
    from bulletproofspp_tpu.core.engine import HostEngine
    from bulletproofspp_tpu.ops.engine import JaxEngine

    rng2 = _r.Random(123)
    pts, p = [], ec.G
    for _ in range(7):
        pts.append(p)
        p = ec.dbl(p)
    host, dev = HostEngine(), JaxEngine(host_below=0)
    ga = [([rng2.randrange(R) for _ in range(4)], pts[:4])]
    gb = [([rng2.randrange(R) for _ in range(3)], pts[4:])]
    gc = [([rng2.randrange(R) for _ in range(7)], pts)]
    assert dev.msm_pair(ga, gb) == host.msm_pair(ga, gb)
    assert dev.msm_many([ga, gb, gc]) == host.msm_many([ga, gb, gc])


@pytest.mark.slow
def test_engine_fuzz_equivalence():
    """Randomized MSM/fold/shared_mul instances: device engine must agree
    with the exact host engine on mixed sizes, zero scalars, None points,
    duplicated points, and boundary scalars."""
    import random as _r

    from bulletproofspp_tpu.core import ec
    from bulletproofspp_tpu.core.engine import HostEngine
    from bulletproofspp_tpu.ops.engine import JaxEngine

    rng2 = _r.Random(2025)
    host, dev = HostEngine(), JaxEngine(host_below=0)
    pool = [ec.scalar_mul(rng2.randrange(1, R), ec.G) for _ in range(12)]

    for trial in range(6):
        n = rng2.choice([1, 2, 3, 5, 9, 14])
        pts = [rng2.choice(pool + [None]) for _ in range(n)]
        scal = [
            rng2.choice([0, 1, R - 1, R, rng2.randrange(R), rng2.randrange(R)])
            for _ in range(n)
        ]
        pairs = list(zip(scal, pts))
        assert dev.msm(pairs) == host.msm(pairs), (trial, "msm")

    for trial in range(3):
        n = rng2.choice([1, 3, 6])
        ge = [rng2.choice(pool) for _ in range(n)]
        go = [rng2.choice(pool + [None]) for _ in range(n)]
        b = rng2.randrange(-(2**128), 2**128)
        a = rng2.randrange(-(2**128), 2**128)
        got = dev.fold_bv(b, a, ge, go)
        want = host.fold_bv(b, a, ge, go)
        assert got.to_host()[: len(want)] == want, (trial, "fold")

    k = rng2.randrange(R)
    assert dev.shared_mul(k, pool[:4]) == host.shared_mul(k, pool[:4])
