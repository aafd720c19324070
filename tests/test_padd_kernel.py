"""The CUDA complete addition (native/bppp_padd.cu, ops/padd_cuda.py) on the CPU.

On the CPU backend the kernel's source is built with g++ into a host loop
behind the same FFI handler, so these tests run the real wrapper, its
batching rule, the (batch..., 16, n) layout and the kernel's arithmetic,
and compare them with the XLA reference (``curve.padd``) and host
bignums.  The nvcc build runs on the card in tests/test_gpu.py.
"""

import random
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from bulletproofspp_tpu.core import ec
from bulletproofspp_tpu.core.fields import Q, R
from bulletproofspp_tpu.ops import curve, glv, limb, msm, padd_cuda

rng = random.Random(41)


@pytest.fixture(autouse=True)
def _gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable: the kernel's host build cannot be made")


def _rand_points(n):
    return [ec.scalar_mul(rng.randrange(1, R), ec.G) for _ in range(n)]


def _saturated(points):
    """Projective planes with Z = 2^256 - 1 (every limb 0xFFFF, a
    non-canonical representative) and X, Y scaled to match."""
    z = (1 << 256) - 1
    xs, ys, zs = [], [], []
    for pt in points:
        if pt is None:
            xs.append(0), ys.append(z), zs.append(0)
        else:
            xs.append(pt[0] * z % Q), ys.append(pt[1] * z % Q), zs.append(z)
    return tuple(jnp.asarray(limb.pack_ints(v)) for v in (xs, ys, zs))


@pytest.mark.parametrize("case", ["random", "complete_cases", "projective_inputs", "saturated_z"])
def test_kernel_matches_host(case):
    if case == "complete_cases":
        p1, p2 = _rand_points(2)
        a = [p1, p1, p1, p1, None, None, ec.G]
        b = [p2, p1, ec.neg(p1), None, p2, None, ec.G]
    else:
        a, b = _rand_points(24) + [None], _rand_points(24) + [ec.G]
    want = [ec.add(x, y) for x, y in zip(a, b)]
    if case == "saturated_z":
        pa, pb = _saturated(a), _saturated(b)
    else:
        pa, pb = curve.from_affine_host(a), curve.from_affine_host(b)
    if case == "projective_inputs":
        # doubled inputs carry Z != 1 and non-canonical limbs
        pa, pb = curve.pdbl(pa), curve.pdbl(pb)
        want = [ec.add(ec.dbl(x), ec.dbl(y)) for x, y in zip(a, b)]
    out = padd_cuda.padd(pa, pb)
    assert all(int(np.asarray(t).max()) < 1 << 16 for t in out)  # the limb format
    assert curve.to_affine_host(out) == want


# saturated 0xFFFF runs, values in [p, 2^256), the operand that once
# exposed a dropped carry in limb.mul, and randoms
SAT = [
    0,
    1,
    Q - 1,
    Q,
    Q + 5,
    (1 << 256) - 1,
    (1 << 256) - (1 << 32),
    int("FFFF" * 8 + "0000" * 8, 16),
    int("FFFF0000" * 8, 16),
    94329926858193610711403129864407773699609837703255222953893265490612872160623,
]


@pytest.mark.parametrize("shift", [0, 3, 7])
def test_kernel_polynomial_matches_xla_on_adversarial_limbs(shift):
    """The RCB formulas are polynomials, so on arbitrary (off-curve)
    coordinates the kernel and the XLA body must agree mod p: every
    field operation of the kernel meets saturated and non-canonical
    operands here."""
    vals = SAT + [rng.randrange(1 << 256) for _ in range(22)]
    rot = lambda k: vals[k:] + vals[:k]  # noqa: E731
    p = tuple(jnp.asarray(limb.pack_ints(rot(shift + i))) for i in range(3))
    q = tuple(jnp.asarray(limb.pack_ints(rot(shift + 3 + i))) for i in range(3))
    got = [limb.unpack_ints(np.asarray(limb.normalize(c))) for c in padd_cuda.padd(p, q)]
    want = [limb.unpack_ints(np.asarray(limb.normalize(c))) for c in curve.padd(p, q)]
    assert got == want


def test_kernel_chain_matches_xla():
    a, b = _rand_points(16), _rand_points(16)
    pa, pb = curve.from_affine_host(a), curve.from_affine_host(b)

    def chain(add):
        return jax.lax.scan(lambda c, _: (add(c, pb), None), pa, None, length=5)[0]

    assert curve.to_affine_host(jax.jit(lambda: chain(padd_cuda.padd))()) == curve.to_affine_host(
        chain(curve.padd)
    )


@pytest.mark.parametrize("layout", ["leading_batch", "trailing_axis", "nested"])
def test_kernel_batched_layouts(layout):
    a, b = _rand_points(12), _rand_points(12)
    want = [ec.add(x, y) for x, y in zip(a, b)]
    pa, pb = curve.from_affine_host(a), curve.from_affine_host(b)
    if layout == "leading_batch":
        sa = tuple(jnp.stack([t, u]) for t, u in zip(pa, pb))
        sb = tuple(jnp.stack([u, u]) for u in pb)
        out = jax.vmap(padd_cuda.padd)(sa, sb)
        assert curve.to_affine_host(tuple(t[0] for t in out)) == want
        assert curve.to_affine_host(tuple(t[1] for t in out)) == [ec.dbl(y) for y in b]
        return
    pa3 = tuple(t.reshape(16, 3, 4) for t in pa)
    pb3 = tuple(t.reshape(16, 3, 4) for t in pb)
    if layout == "nested":
        inner = jax.vmap(padd_cuda.padd, in_axes=1, out_axes=1)
        f = jax.vmap(inner, in_axes=1, out_axes=1)
    else:
        f = jax.vmap(padd_cuda.padd, in_axes=2, out_axes=2)
    out = f(pa3, pb3)
    assert curve.to_affine_host(tuple(t.reshape(16, 12) for t in out)) == want


def test_kernel_rejects_a_bad_layout():
    pa = curve.from_affine_host(_rand_points(10))
    out = jax.ShapeDtypeStruct(pa[0].shape, jnp.uint32)
    call = jax.ffi.ffi_call("bppp_padd", (out, out, out), vmap_method="broadcast_all")
    padd_cuda._register()
    with pytest.raises(Exception, match="planes are not"):
        jax.block_until_ready(call(*pa, *pa, n=np.int64(7)))


@pytest.mark.parametrize(
    "backend,want", [("gpu", True), ("cpu", False), ("rocm", RuntimeError)]
)
def test_kernel_choice_by_backend(monkeypatch, backend, want):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="unsupported JAX backend"):
            curve.use_padd_kernel()
    else:
        assert curve.use_padd_kernel() is want


@pytest.mark.parametrize("op", ["padd_auto", "pdbl_auto"])
def test_gpu_branch_dispatches_to_the_kernel(monkeypatch, op):
    calls = []
    real = padd_cuda.padd

    def spy(p, q):
        calls.append(p[0].shape)
        return real(p, q)

    monkeypatch.setattr(curve, "use_padd_kernel", lambda: True)
    monkeypatch.setattr(padd_cuda, "padd", spy)
    a, b = _rand_points(6), _rand_points(6)
    pa, pb = curve.from_affine_host(a), curve.from_affine_host(b)
    if op == "padd_auto":
        got, want = curve.padd_auto(pa, pb), [ec.add(x, y) for x, y in zip(a, b)]
    else:
        got, want = curve.pdbl_auto(pa), [ec.dbl(x) for x in a]
    assert calls == [(16, 6)]
    assert curve.to_affine_host(got) == want


@pytest.mark.parametrize("lanes", [16, 128, "vmap"])
def test_msm_through_the_kernel_matches_host(monkeypatch, lanes):
    """The whole MSM (table build, lane reduction, Horner) on the GPU
    branch, with the kernel's host build doing every addition."""
    monkeypatch.setattr(curve, "use_padd_kernel", lambda: True)
    L = 32 if lanes == "vmap" else lanes
    n = L // 2
    pts = _rand_points(n)
    entries = 2 if lanes == "vmap" else 1
    args, wants = [], []
    for _ in range(entries):
        scalars = [rng.randrange(R) for _ in range(n)]
        halves, lane_pts = [], []
        for s, q in zip(scalars, pts):
            halves += list(glv.split(s))
            lane_pts += [q, ec.endo(q)]
        absd, sgn = glv.recode_batch(halves)
        args.append((*curve.from_affine_host(lane_pts), jnp.asarray(absd), jnp.asarray(sgn)))
        wants.append(ec.msm_host(scalars, pts))
    if lanes == "vmap":
        stacked = [jnp.stack(t) for t in zip(*args)]
        out = jax.jit(jax.vmap(msm.msm_kernel))(*stacked)
        got = [curve.to_affine_host(tuple(t[i] for t in out))[0] for i in range(entries)]
    else:
        got = [curve.to_affine_host(jax.jit(msm.msm_kernel)(*args[0]))[0]]
    assert got == wants
