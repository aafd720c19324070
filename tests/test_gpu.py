"""The compiled device path on an NVIDIA GPU.

Run on the card with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``;
elsewhere every test here skips through the ``gpu`` fixture.
"""

import random

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from bulletproofspp_tpu.core import ec
from bulletproofspp_tpu.core.fields import R
from bulletproofspp_tpu.ops import curve, limb, msm, padd_cuda

pytestmark = pytest.mark.gpu

rng = random.Random(53)


def _points(n):
    base = [ec.scalar_mul(rng.randrange(1, R), ec.G) for _ in range(16)]
    pts = [base[i % 16] for i in range(n)]
    pts[0], pts[1] = None, ec.G  # identity and a doubling lane below
    return pts


@pytest.mark.parametrize("shape", [(512,), (300,), (33, 5)])
def test_padd_kernel_matches_host(gpu, shape):
    assert curve.use_padd_kernel()
    n = int(np.prod(shape))
    a, b = _points(n), list(reversed(_points(n)))
    b[1] = ec.G
    pa = tuple(t.reshape(limb.NLIMB, *shape) for t in curve.from_affine_host(a))
    pb = tuple(t.reshape(limb.NLIMB, *shape) for t in curve.from_affine_host(b))
    out = jax.jit(curve.padd_auto)(pa, pb)
    flat = tuple(t.reshape(limb.NLIMB, n) for t in out)
    assert curve.to_affine_host(flat) == [ec.add(x, y) for x, y in zip(a, b)]


def test_padd_kernel_chain_matches_xla(gpu):
    a, b = _points(256), _points(256)[::-1]
    pa, pb = curve.from_affine_host(a), curve.from_affine_host(b)

    def chain(add):
        return jax.jit(lambda p, q: jax.lax.scan(lambda c, _: (add(c, q), None), p, None, length=6)[0])

    got = chain(padd_cuda.padd)(pa, pb)
    want = chain(curve.padd)(pa, pb)
    assert all(bool(jnp.all(limb.normalize(x) == limb.normalize(y))) for x, y in zip(got, want))


def test_vmapped_msm_matches_host(gpu):
    """The engine's dispatch: jax.vmap(msm_kernel) with the kernel inside."""
    B, n = 2, 256
    pts = _points(n)
    pts[0] = ec.G
    from bulletproofspp_tpu.ops.engine import _msm_lanes

    wants, digits = [], []
    for _ in range(B):
        sc = [rng.randrange(R) for _ in range(n)]
        wants.append(ec.msm_host(sc, pts))
        absd, sgn, lanes = _msm_lanes(list(zip(sc, pts)))
        digits.append((absd, sgn))
    px, py, pz = curve.from_affine_host(lanes)
    stack = lambda t: jnp.stack([t] * B)  # noqa: E731
    absd = jnp.asarray(np.stack([d[0] for d in digits]))
    sgn = jnp.asarray(np.stack([d[1] for d in digits]))
    out = msm._msm_pair_compiled(stack(px), stack(py), stack(pz), absd, sgn)
    got = [curve.to_affine_host(tuple(t[i] for t in out))[0] for i in range(B)]
    assert got == wants
