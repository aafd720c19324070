"""Curve kernels, GLV decomposition, and MSM/fold kernels vs host ground truth."""

import random

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from bulletproofspp_tpu.core import ec
from bulletproofspp_tpu.core.fields import R
from bulletproofspp_tpu.ops import curve, glv, limb, msm
from bulletproofspp_tpu.ops.engine import JaxEngine, _endo_host

rng = random.Random(99)


def rand_points(n):
    return [ec.scalar_mul(rng.randrange(1, R), ec.G) for _ in range(n)]


def test_padd_complete_cases():
    """P+Q, P+P, P+(-P), P+O, O+O through one branchless formula."""
    p1, p2 = rand_points(2)
    lanes_a = [p1, p1, p1, p1, None, None]
    lanes_b = [p2, p1, ec.neg(p1), None, p2, None]
    want = [ec.add(a, b) for a, b in zip(lanes_a, lanes_b)]
    pa = curve.from_affine_host(lanes_a)
    pb = curve.from_affine_host(lanes_b)
    got = curve.to_affine_host(curve.padd(pa, pb))
    assert got == want


def test_pdbl():
    pts = rand_points(3) + [None]
    want = [ec.dbl(p) for p in pts]
    got = curve.to_affine_host(curve.pdbl(curve.from_affine_host(pts)))
    assert got == want


def test_endo():
    pts = rand_points(2)
    got = curve.to_affine_host(curve.endo(curve.from_affine_host(pts)))
    assert got == [ec.endo(p) for p in pts]
    # phi(P) == lambda * P
    assert got[0] == ec.scalar_mul(ec.LAMBDA, pts[0])


def test_device_to_affine():
    pts = rand_points(3) + [None]
    proj = curve.from_affine_host(pts)
    proj = curve.pdbl(proj)  # non-trivial Z
    xn, yn, inf = curve.to_affine(proj)
    assert curve.affine_lanes_to_host(xn, yn, inf) == [ec.dbl(p) for p in pts]


def test_glv_split_bounds():
    for _ in range(20):
        k = rng.randrange(R)
        k1, k2 = glv.split(k)
        assert (k1 + k2 * ec.LAMBDA - k) % R == 0
        assert abs(k1) < 1 << 130 and abs(k2) < 1 << 130


def test_recode_signed():
    for v in [0, 1, -1, 8, -8, 2**129 - 1, -(2**129), rng.randrange(1 << 130)]:
        absd, sgn = glv.recode_signed(v)
        got = sum(
            int(a) * (-1 if s else 1) * 16 ** (glv.ROWS - 1 - j)
            for j, (a, s) in enumerate(zip(absd, sgn))
        )
        assert got == v, v


def test_msm_kernel_small():
    n = 8
    pts = rand_points(n)
    scalars = [rng.randrange(R) for _ in range(n)]
    want = ec.msm_host(scalars, pts)
    eng = JaxEngine(host_below=0)
    got = eng.msm(list(zip(scalars, pts)))
    assert got == want


def test_msm_edge_cases():
    eng = JaxEngine(host_below=0)
    assert eng.msm([]) is None
    p = rand_points(1)[0]
    assert eng.msm([(0, p), (5, None)]) is None
    # single pair
    assert eng.msm([(7, p)]) == ec.scalar_mul(7, p)
    # cancellation to the identity
    assert eng.msm([(3, p), (R - 3, p)]) is None


def test_fold_bases_matches_host():
    n = 5
    ge, go = rand_points(n), rand_points(n)
    b, a = -(2**100 + 12345), 2**90 + 7
    eng = JaxEngine(host_below=0)
    got = eng.fold_bases(b, a, ge, go)
    want = [ec.double_base_mul(b, e, a, o) for e, o in zip(ge, go)]
    assert got == want


def test_shared_mul_matches_host():
    pts = rand_points(3)
    k = rng.randrange(R)
    eng = JaxEngine(host_below=0)
    assert eng.shared_mul(k, pts) == [ec.scalar_mul(k, p) for p in pts]


def test_shared_mul_none_identity_lanes():
    """None entries are identity lanes (HostEngine parity); the device
    path used to crash computing endo(None)."""
    from bulletproofspp_tpu.core.engine import HostEngine

    pts = [rand_points(1)[0], None, rand_points(1)[0]]
    k = rng.randrange(R)
    eng = JaxEngine(host_below=0)
    assert eng.shared_mul(k, pts) == HostEngine().shared_mul(k, pts)


def test_basevec_cache_is_bounded():
    eng = JaxEngine(host_below=0)
    eng._bv_cache_max = 4
    keep = [rand_points(2) for _ in range(8)]  # hold refs: ids stay unique
    for pts in keep:
        eng.basevec_cached(pts)
    assert len(eng._bv_cache) <= 4
    # most-recent entry still hits (identity check passes)
    bv = eng._bv_cache[id(keep[-1])][1]
    assert eng.basevec_cached(keep[-1]) is bv


@pytest.mark.parametrize("lanes", [128, 1024, 4096])
def test_xla_msm_matches_host(lanes):
    """msm_kernel on the XLA path at lane counts from 128 to 4096 lanes:
    P_i = 2^i G, so the exact answer is one host scalar multiple
    (sum s_i 2^i mod R) G."""
    n = lanes // 2
    pts, p = [], ec.G
    for _ in range(n):
        pts.append(p)
        p = ec.dbl(p)
    scalars = [rng.randrange(R) for _ in range(n)]
    halves, lane_pts = [], []
    for s, q in zip(scalars, pts):
        halves += list(glv.split(s))
        lane_pts += [q, _endo_host(q)]
    absd, sgn = glv.recode_batch(halves)
    px, py, pz = curve.from_affine_host(lane_pts)
    got = curve.to_affine_host(msm.run_msm(px, py, pz, jax.numpy.asarray(absd), jax.numpy.asarray(sgn)))[0]
    assert got == ec.scalar_mul(sum(s << i for i, s in enumerate(scalars)) % R, ec.G)
