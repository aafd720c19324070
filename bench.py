"""Benchmark (NVIDIA GPU): MSM throughput + optional proof benches.

Prints ONE JSON line on stdout:
  {"metric", "value", "unit", "vs_baseline", "device", ...}

The reference publishes no timing numbers (BASELINE.md "published: {}"),
and no roofline has been measured on the card yet, so ``vs_baseline`` is
null.  The exact host-integer engine (the reference's Straus/GLV
algorithm, reference: src/Commitment.hs:311-353) is also measured on a
small instance and reported per-point as ``vs_host_engine`` for scale.

Every sample ends in ``block_until_ready`` on distinct pre-staged inputs,
so dispatch pipelining cannot hide work.  Off the GPU the script exits
non-zero: a CPU number is never reported as a device number.

BENCH_FULL=1 additionally reports prove/verify/batch-verify rates for the
64-bit range-proof config on stderr.
"""

from __future__ import annotations

import json
import os
import random
import statistics
import subprocess
import sys
import time

os.environ.setdefault("BPPP_ENGINE", "jax")

# every measured quantity is sampled BENCH_REPS (default 5) times; the JSON
# reports the MEDIAN and the IQR (75th - 25th percentile)
REPS = int(os.environ.get("BENCH_REPS", "5"))
# repeats for the (long) BENCH_FULL sections; each of their quantities is
# still a median over >=3 full waves
FULL_REPS = int(os.environ.get("BENCH_FULL_REPS", "3"))


def _median(xs):
    return statistics.median(xs)


def _iqr(xs):
    if len(xs) < 2:
        return 0.0
    qs = statistics.quantiles(xs, n=4, method="inclusive")
    return qs[2] - qs[0]


def device_info():
    """The card as JAX and nvidia-smi report it; exits non-zero off the GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs an NVIDIA GPU; JAX found {dev.platform!r}", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "nvidia_smi": smi[0].strip() if smi else None,
    }


def bench_msm(n_points: int, iters: int):
    """Production-shaped measurement: the basis is fixed (packed once, as
    the engine does for every setup), per-iteration work is fresh scalars
    -> native GLV digit recode -> device MSM."""
    import jax
    import jax.numpy as jnp

    from bulletproofspp_tpu.core import ec
    from bulletproofspp_tpu.core.fields import R
    from bulletproofspp_tpu.ops import curve, glv
    from bulletproofspp_tpu.ops.engine import _interleave_endo
    from bulletproofspp_tpu.ops.msm import run_msm
    from bulletproofspp_tpu import native

    rng = random.Random(2024)
    pts, p = [], ec.G
    for _ in range(n_points):
        pts.append(p)
        p = ec.dbl(p)

    # host baseline (reference algorithm, exact integers)
    base_n = min(64, n_points)
    scalars = [rng.randrange(R) for _ in range(n_points)]
    t0 = time.perf_counter()
    ec.msm_host(scalars[:base_n], pts[:base_n])
    host_pps = base_n / (time.perf_counter() - t0)

    x, y, z = curve.from_affine_host(pts)
    px, py, pz = _interleave_endo(x, y, z)  # endomorphism on device
    jax.block_until_ready((px, py, pz))

    def msm_call(a):
        return run_msm(px, py, pz, *a)

    # scalar GENERATION is excluded from the e2e figure (it is test-input
    # synthesis, not pipeline work); GLV split + digit recode + transfer
    # are included
    scalar_sets = {}

    def digits(seed):
        svals = scalar_sets.get(seed)
        if svals is None:
            r = random.Random(seed)
            svals = scalar_sets[seed] = [r.randrange(R) for _ in range(n_points)]
        nat = native.glv_recode_batch(svals)
        if nat is None:
            halves = []
            for s in svals:
                k1, k2 = glv.split(s)
                halves += [k1, k2]
            nat = glv.recode_batch(halves)
        return jnp.asarray(nat[0]), jnp.asarray(nat[1])

    argsets = [digits(i) for i in range(iters)]
    jax.block_until_ready(argsets)

    def one_call(a):
        t0 = time.perf_counter()
        jax.block_until_ready(msm_call(a))
        return time.perf_counter() - t0

    one_call(argsets[0])  # warm (compile + cache)
    samples = [one_call(a) for _ in range(REPS) for a in argsets]
    dev_s = _median(samples)

    # end-to-end including per-iteration host scalar pipeline (GLV split
    # + recode + transfer; scalars are pre-generated into scalar_sets so
    # the timed region never runs randrange)
    state = {"i": 0}
    for i in range(1, max(3, REPS) + 2):
        digits(100 + 31 * i)

    def e2e_call():
        i = state["i"] = state["i"] + 1
        t0 = time.perf_counter()
        jax.block_until_ready(msm_call(digits(100 + 31 * i)))
        return time.perf_counter() - t0

    e2e_call()  # warm
    e2e_s = _median([e2e_call() for _ in range(max(3, REPS))])
    print(
        json.dumps(
            {
                "msm_device_ms": dev_s * 1e3,
                "msm_device_iqr_ms": _iqr(samples) * 1e3,
                "msm_e2e_with_host_scalar_prep_ms": e2e_s * 1e3,
                "bench_reps": REPS,
                "n_points": n_points,
            }
        ),
        file=sys.stderr,
    )
    return n_points / dev_s, host_pps


def bench_proofs():
    """prove/verify/batch-verify rates for the 64-bit config (stderr)."""
    from bulletproofspp_tpu.cli import _resolve_values
    from bulletproofspp_tpu.core import range_proof as rpm
    from bulletproofspp_tpu.core.batch import batch_verify
    from bulletproofspp_tpu.core.engine import default_engine
    from bulletproofspp_tpu.core.transcript import take_points
    from bulletproofspp_tpu.io_ import schema as schema_mod

    spec_obj = {
        "basisSeed": "bench points",
        "argument": "NL",
        "ranges": [{"base": 16, "min": 0, "max": 2**64, "isOutput": True}],
    }
    engine = default_engine()
    spec = schema_mod.parse_spec(spec_obj)
    points = take_points(spec.basis_seed.encode(), schema_mod.points_needed(spec))
    setup = schema_mod.build_setup(spec, points)

    def mk(i):
        values = _resolve_values(spec, schema_mod.parse_witness([{"amount": 10**9 + i}]))
        return rpm.prove(setup, values, f"bench{i}".encode(), engine)

    mk(0)  # warm all kernel shapes
    n = int(os.environ.get("BENCH_PROOFS", "8"))

    def med_rate(wave, count):
        """Median/IQR of per-item rate over FULL_REPS waves (wave(i) runs
        `count` items and is assumed warm)."""
        rates = []
        for r in range(FULL_REPS):
            t0 = time.perf_counter()
            wave(r)
            rates.append(count / (time.perf_counter() - t0))
        return _median(rates), _iqr(rates)

    proofs = [mk(i) for i in range(n)]  # warm + corpus for verify

    def prove_wave(r):
        for i in range(n):
            mk(1000 * (r + 1) + i)

    prove_rate, prove_iqr = med_rate(prove_wave, n)

    rpm.verify(setup, proofs[0], engine)
    oks = []

    def verify_wave(_r):
        oks.append(all(rpm.verify(setup, pr, engine) for pr in proofs))

    verify_rate, verify_iqr = med_rate(verify_wave, n)
    ok = all(oks)

    items = [(setup, pr) for pr in proofs]
    batch_verify(items, engine)
    okbs = []

    def batch_wave(_r):
        okbs.append(batch_verify(items, engine))

    batch_rate, _ = med_rate(batch_wave, n)
    okb = all(okbs)

    # pipelined proving: independent proofs from worker threads overlap
    # host transcript work with device dispatch (the production serving
    # shape; device queues serialize the EC work)
    from concurrent.futures import ThreadPoolExecutor

    workers = int(os.environ.get("BENCH_PROVE_THREADS", "4"))
    with ThreadPoolExecutor(workers) as ex:
        list(ex.map(mk, range(2)))  # warm thread paths

        def pipe_wave(r):
            list(ex.map(mk, range(5000 * (r + 1), 5000 * (r + 1) + 2 * n)))

        pipe_rate, _ = med_rate(pipe_wave, 2 * n)

    # lockstep batch proving: N provers, ONE fused dispatch per phase
    from bulletproofspp_tpu.core.lockstep import prove_lockstep

    nlock = int(os.environ.get("BENCH_LOCKSTEP_N", "16"))
    items = [
        (_resolve_values(spec, schema_mod.parse_witness([{"amount": 10**9 + i}])), f"lk{i}".encode())
        for i in range(nlock)
    ]
    # warm with the SAME batch size: the fused dispatch shapes depend on
    # N, so a smaller warm run would leave every fused compile inside
    # the timed region
    lk = prove_lockstep(setup, items, engine)
    lock_rate, lock_iqr = med_rate(lambda r: prove_lockstep(setup, items, engine), nlock)
    ok_lk = rpm.verify(setup, lk[0], engine)
    print(
        json.dumps(
            {
                "proves_per_s": round(prove_rate, 3),
                "proves_per_s_iqr": round(prove_iqr, 3),
                "proves_per_s_pipelined": round(pipe_rate, 3),
                "proves_per_s_lockstep_n16": round(lock_rate, 3),
                "proves_per_s_lockstep_iqr": round(lock_iqr, 3),
                "verifies_per_s": round(verify_rate, 3),
                "verifies_per_s_iqr": round(verify_iqr, 3),
                "batch_verifies_per_s": round(batch_rate, 3),
                "all_valid": bool(ok and okb and ok_lk),
                "n": n,
                "full_reps": FULL_REPS,
            }
        ),
        file=sys.stderr,
    )


def bench_mixed():
    """Mixed-schema serving workload through prove_many: interleaved
    64-bit / 32-bit / typed-reciprocal requests, bucketed by fusion
    signature and lockstepped per bucket.  The comparison
    point is the thread-pipelined rate (the old fallback for
    heterogeneous batches)."""
    from bulletproofspp_tpu.cli import _resolve_values
    from bulletproofspp_tpu.core import range_proof as rpm
    from bulletproofspp_tpu.core.engine import default_engine
    from bulletproofspp_tpu.core.lockstep import prove_many
    from bulletproofspp_tpu.core.transcript import take_points
    from bulletproofspp_tpu.io_ import schema as schema_mod

    engine = default_engine()

    def make(spec_obj, wit, n, tag):
        spec = schema_mod.parse_spec(spec_obj)
        points = take_points(spec.basis_seed.encode(), schema_mod.points_needed(spec))
        setup = schema_mod.build_setup(spec, points)
        return [
            (setup, _resolve_values(spec, schema_mod.parse_witness(wit)), f"{tag}{i}".encode())
            for i in range(n)
        ]

    spec32 = {
        "basisSeed": "bench points 32",
        "argument": "NL",
        "ranges": [{"base": 16, "min": 0, "max": 2**32, "isOutput": True}],
    }
    spec_rec = {
        "basisSeed": "bench points rec",
        "argument": "NL",
        "ranges": [
            {"base": 16, "min": 0, "max": 2**64, "isOutput": True},
            {"base": 16, "min": 0, "max": 2**64, "isOutput": False},
        ],
    }
    n_each = int(os.environ.get("BENCH_MIXED_N", "8"))
    items = (
        make(_BENCH64_SPEC, [{"amount": 12345}], 2 * n_each, "a")
        + make(spec32, [{"amount": 77}], n_each, "b")
        + make(spec_rec, [{"amount": 500}, {"amount": 500}], n_each, "c")
    )
    # interleave so bucketing (not input order) does the grouping
    by_tag = [items[i::4] for i in range(4)]
    items = [it for group in zip(*by_tag) for it in group]

    prove_many(items, engine)  # warm every bucket's fused shapes
    rates = []
    for _ in range(FULL_REPS):
        t0 = time.perf_counter()
        proofs = prove_many(items, engine)
        rates.append(len(items) / (time.perf_counter() - t0))
    ok = all(
        rpm.verify(setup, pr, engine) for (setup, _v, _s), pr in zip(items, proofs)
    )
    print(
        json.dumps(
            {
                "mixed_n": len(items),
                "mixed_schemas": 3,
                "mixed_proves_per_s": round(_median(rates), 2),
                "mixed_proves_per_s_iqr": round(_iqr(rates), 2),
                "mixed_all_valid": bool(ok),
            }
        ),
        file=sys.stderr,
    )


_BENCH64_SPEC = {
    "basisSeed": "bench points",
    "argument": "NL",
    "ranges": [{"base": 16, "min": 0, "max": 2**64, "isOutput": True}],
}


def bench_serve():
    """Serving throughput through the ACTUAL user surface: the TCP
    dynamic-batching proof service (serve.py).  Concurrent clients
    pipeline mixed-schema prove requests; the collector coalesces them
    into lockstep groups, so the serve rate should approach the lockstep
    rate (not the single-stream rate) — that convergence is the number
    this bench pins.  A second wave measures verify requests/s (one
    merged zero-check MSM per batch with per-request verdicts)."""
    from concurrent.futures import ThreadPoolExecutor

    from bulletproofspp_tpu.serve import ProofServer, request

    spec32 = {
        "basisSeed": "bench points",
        "argument": "NL",
        "ranges": [{"base": 16, "min": 0, "max": 2**32, "isOutput": True}],
    }
    n = int(os.environ.get("BENCH_SERVE_N", "32"))
    clients = int(os.environ.get("BENCH_SERVE_CLIENTS", "4"))
    with ProofServer(linger_ms=20, max_batch=64) as srv:
        # production servers pre-compile the fused dispatch shapes before
        # taking traffic; without this the first waves measure XLA compiles
        # of the N=8/16 lockstep shapes, not serving throughput
        srv.service.warm(
            [(_BENCH64_SPEC, [{"amount": 12345}]), (spec32, [{"amount": 77}])]
        )

        def prove_wave(tag, count):
            # exactly `count` requests total (the rate divides by count):
            # client c sends per + 1 extra for the first count % clients
            per = count // clients
            extra = count % clients

            def one_client(c):
                mine = per + (1 if c < extra else 0)
                reqs = [
                    {"op": "prove",
                     "schema": _BENCH64_SPEC if (c + i) % 2 == 0 else spec32,
                     "witness": [{"amount": 10**6 + c * (per + 1) + i}],
                     "seed": f"{tag}{c}.{i}".encode().hex()}
                    for i in range(mine)
                ]
                return request("127.0.0.1", srv.port, reqs) if reqs else []

            with ThreadPoolExecutor(clients) as ex:
                return [r for rs in ex.map(one_client, range(clients)) for r in rs]

        warm = prove_wave("w", 2 * clients)  # compile every fused shape
        prove_rates, resps = [], None
        for w in range(FULL_REPS):
            t0 = time.perf_counter()
            resps = prove_wave(f"b{w}.", n)
            prove_rates.append(n / (time.perf_counter() - t0))
            assert len(resps) == n, (len(resps), n)
            assert all(r["ok"] for r in resps), [r for r in resps if not r["ok"]][:1]

        # verify wave over the proofs just produced.  Each proof's schema
        # is recomputed from the SAME client-major (c + i) % 2 layout the
        # prove wave generated, so the pairing stays correct for any
        # n/clients split
        per_p, extra_p = n // clients, n % clients
        schemas = [
            _BENCH64_SPEC if (c + i) % 2 == 0 else spec32
            for c in range(clients)
            for i in range(per_p + (1 if c < extra_p else 0))
        ]
        ventries = list(zip(schemas, resps))
        per = -(-n // clients)

        def verify_client(c):
            mine = ventries[c * per : (c + 1) * per]
            reqs = [
                {"op": "verify", "schema": s,
                 "commits": r["commits"], "proof": r["proof"]}
                for s, r in mine
            ]
            return request("127.0.0.1", srv.port, reqs) if reqs else []

        verify_rates, oks = [], []
        with ThreadPoolExecutor(clients) as ex:
            list(ex.map(verify_client, range(clients)))  # warm
            for _ in range(FULL_REPS):
                t0 = time.perf_counter()
                vresps = [r for rs in ex.map(verify_client, range(clients)) for r in rs]
                verify_rates.append(len(vresps) / (time.perf_counter() - t0))
                # an empty wave would read as 0.0/s with all_valid=true
                # (all() over []): fail loudly
                assert len(vresps) == n, (len(vresps), n)
                oks.append(all(r["ok"] and r["valid"] for r in vresps))
        ok = all(oks)
        stats = request("127.0.0.1", srv.port, [{"op": "stats"}])[0]
    print(
        json.dumps(
            {
                "serve_n": n,
                "serve_clients": clients,
                "serve_proves_per_s": round(_median(prove_rates), 2),
                "serve_proves_per_s_iqr": round(_iqr(prove_rates), 2),
                "serve_verifies_per_s": round(_median(verify_rates), 2),
                "serve_verifies_per_s_iqr": round(_iqr(verify_rates), 2),
                "serve_mean_batch": round(stats["requests"] / max(1, stats["batches"]), 1),
                "serve_all_valid": bool(ok),
                "serve_parse_s": round(stats.get("parse_s", 0.0), 2),
                "serve_prove_exec_s": round(stats.get("prove_exec_s", 0.0), 2),
                "serve_verify_exec_s": round(stats.get("verify_exec_s", 0.0), 2),
                "serve_queue_wait_s": round(stats.get("queue_wait_s", 0.0), 2),
            }
        ),
        file=sys.stderr,
    )


def _gen_proof_chunk(args):
    """Worker (spawned, host engine only, off the card): prove a range of
    64-bit proofs and return their wire bytes."""
    lo, hi = args
    os.environ["BPPP_ENGINE"] = "host"
    os.environ["JAX_PLATFORMS"] = "cpu"  # before anything imports jax
    from bulletproofspp_tpu.cli import _resolve_values
    from bulletproofspp_tpu.core import range_proof as rpm
    from bulletproofspp_tpu.core.engine import HostEngine
    from bulletproofspp_tpu.core.transcript import take_points
    from bulletproofspp_tpu.io_ import schema as schema_mod

    engine = HostEngine()
    spec = schema_mod.parse_spec(_BENCH64_SPEC)
    points = take_points(spec.basis_seed.encode(), schema_mod.points_needed(spec))
    setup = schema_mod.build_setup(spec, points)
    out = []
    for i in range(lo, hi):
        values = _resolve_values(spec, schema_mod.parse_witness([{"amount": 10**9 + i}]))
        proof = rpm.prove(setup, values, f"bench{i}".encode(), engine)
        out.append(rpm.encode_proof(setup, proof))
    return out


def _load_or_gen_proofs(n: int):
    """n distinct same-schema proofs as wire bytes, cached on disk (one-time
    host proving; spawned CPU-only workers leave the card to this process)."""
    import pickle

    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".bench_cache")
    os.makedirs(cache, exist_ok=True)
    path = os.path.join(cache, f"proofs_{n}.pkl")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing as mp

    workers = min(16, os.cpu_count() or 1)
    step = -(-n // workers)
    chunks = [(i, min(i + step, n)) for i in range(0, n, step)]
    with ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn")) as ex:
        blobs = [b for chunk in ex.map(_gen_proof_chunk, chunks) for b in chunk]
    with open(path, "wb") as f:
        pickle.dump(blobs, f)
    return blobs


def bench_batch_1024():
    """The 1024-proof batched-verification showcase (BASELINE.json
    configs[4]; the reference's TODO, reference: README.md:186): decode
    1024 proofs (ONE device sqrt for all ~13k points) and verify them as
    one merged random-linear-combination MSM."""
    from bulletproofspp_tpu.core.batch import batch_verify_encoded
    from bulletproofspp_tpu.core.engine import default_engine
    from bulletproofspp_tpu.core.transcript import take_points
    from bulletproofspp_tpu.io_ import schema as schema_mod

    n = int(os.environ.get("BENCH_BATCH_N", "1024"))
    engine = default_engine()
    spec = schema_mod.parse_spec(_BENCH64_SPEC)
    points = take_points(spec.basis_seed.encode(), schema_mod.points_needed(spec))
    setup = schema_mod.build_setup(spec, points)
    blobs = _load_or_gen_proofs(n)
    entries = [(setup, coms_b, proof_b) for coms_b, proof_b in blobs]

    oks = [batch_verify_encoded(entries, engine)]  # warm compiles
    dts = []
    for _ in range(FULL_REPS):
        t0 = time.perf_counter()
        oks.append(batch_verify_encoded(entries, engine))
        dts.append(time.perf_counter() - t0)
    dt = _median(dts)
    print(
        json.dumps(
            {
                "batch_n": n,
                "batch_verify_total_s": round(dt, 3),
                "batch_verify_total_s_iqr": round(_iqr(dts), 3),
                "batch_verified_proofs_per_s": round(n / dt, 1),
                "batch_all_valid": bool(all(oks)),
            }
        ),
        file=sys.stderr,
    )


def main():
    # BENCH_ONLY=serve,batch runs just those sub-benches
    device = device_info()
    only = os.environ.get("BENCH_ONLY")
    n_points = int(os.environ.get("BENCH_MSM_POINTS", "32768"))
    iters = int(os.environ.get("BENCH_ITERS", "5"))
    if only:
        parts = {p.strip() for p in only.split(",") if p.strip()}
        fns = {"msm": lambda: bench_msm(n_points, iters),
               "proofs": bench_proofs, "mixed": bench_mixed,
               "serve": bench_serve, "batch": bench_batch_1024}
        unknown = parts - set(fns)
        if unknown:
            raise SystemExit(f"BENCH_ONLY: unknown bench(es) {sorted(unknown)}")
        for name in ("msm", "proofs", "mixed", "serve", "batch"):
            if name in parts:
                fns[name]()
        return
    pps, host_pps = bench_msm(n_points, iters)
    if os.environ.get("BENCH_FULL"):
        bench_proofs()
        bench_mixed()
        bench_serve()
        bench_batch_1024()
    print(
        json.dumps(
            {
                "metric": f"msm_{n_points}pt_throughput",
                "value": pps,
                "unit": "points/s",
                "vs_baseline": None,
                "vs_host_engine": pps / host_pps if host_pps else None,
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    main()
