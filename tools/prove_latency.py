"""Single-stream prove latency breakdown on the live backend.

Times, with a warm engine and warm XLA cache:
  - full rpm.prove() wall time, split into engine-blocking time
    (msm_many / msm_pair / fold / complete_square) vs host time
    (witness folds, transcript, packing)
  - each msm_many call of one prove, with its lane count

Usage:  python tools/prove_latency.py [32|64]
"""

from __future__ import annotations

import sys
import time


def main():
    bits = int(sys.argv[1]) if len(sys.argv) > 1 else 64

    from bulletproofspp_tpu.cli import _resolve_values
    from bulletproofspp_tpu.core import range_proof as rpm
    from bulletproofspp_tpu.io_ import schema as schema_mod
    from bulletproofspp_tpu.core.transcript import take_points
    from bulletproofspp_tpu.ops.engine import JaxEngine

    spec = schema_mod.parse_spec(
        {
            "basisSeed": "lat",
            "argument": "NL",
            "ranges": [{"base": 16, "min": 0, "max": 2**bits, "isOutput": True}],
        }
    )
    pts = take_points(spec.basis_seed.encode(), schema_mod.points_needed(spec))
    setup = schema_mod.build_setup(spec, pts)
    eng = JaxEngine()
    vals = _resolve_values(spec, schema_mod.parse_witness([{"amount": 1234}]))

    # warm everything once
    rpm.prove(setup, vals, b"warm", eng)

    # instrument the engine: wrap the blocking entry points
    import bulletproofspp_tpu.ops.engine as engmod

    counters = {"msm_many": [0, 0.0], "fold": [0, 0.0], "csq": [0, 0.0]}
    orig_many = JaxEngine.msm_many
    orig_fold = JaxEngine.fold_bv
    orig_csq = JaxEngine.complete_square

    def wrap(name, orig):
        def inner(self, *a, **k):
            t0 = time.perf_counter()
            out = orig(self, *a, **k)
            counters[name][0] += 1
            counters[name][1] += time.perf_counter() - t0
            return out

        return inner

    JaxEngine.msm_many = wrap("msm_many", orig_many)
    JaxEngine.fold_bv = wrap("fold", orig_fold)
    JaxEngine.complete_square = wrap("csq", orig_csq)
    try:
        n = 6
        t0 = time.perf_counter()
        for i in range(n):
            rpm.prove(setup, vals, b"x%d" % i, eng)
        total = (time.perf_counter() - t0) / n
        for v in counters.values():
            v[0] //= n
            v[1] /= n
    finally:
        JaxEngine.msm_many = orig_many
        JaxEngine.fold_bv = orig_fold
        JaxEngine.complete_square = orig_csq

    eng_t = sum(v[1] for v in counters.values())
    print(f"prove wall: {total*1e3:.1f} ms  ({1/total:.2f} proves/s)")
    for name, (cnt, t) in counters.items():
        print(f"  {name:10s} calls/prove={cnt:2d}  {t*1e3:7.1f} ms")
    print(f"  engine-blocking total: {eng_t*1e3:.1f} ms")
    print(f"  host (everything else): {(total-eng_t)*1e3:.1f} ms")

    # re-run one prove and time each msm_many call individually
    times = []
    orig = JaxEngine.msm_many

    def timed(self, gl):
        t0 = time.perf_counter()
        out = orig(self, gl)
        lanes = sum(2 * len(sv) for groups in gl for sv, _ in groups)
        times.append((lanes, time.perf_counter() - t0))
        return out

    JaxEngine.msm_many = timed
    try:
        rpm.prove(setup, vals, b"probe", eng)
    finally:
        JaxEngine.msm_many = orig
    print("per-call msm_many (lanes, ms):")
    for lanes, t in times:
        print(f"    {lanes:5d}  {t*1e3:7.1f}")


if __name__ == "__main__":
    main()
