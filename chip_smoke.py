#!/usr/bin/env python3
"""End-to-end smoke test of the system on one NVIDIA GPU.

    python3 chip_smoke.py           # one card: every phase below
    python3 chip_smoke.py --four    # four cards: the sharded path only

Everything runs in this one process, so only one process holds the card;
the GPU-marked tests run first, in a child, before this process touches
JAX.  Phases (each prints one JSON line with its compile seconds, wall
seconds, the device's peak bytes in use so far and its pass/fail facts):

  gpu_tests     ``pytest -m gpu tests/`` in a child
  kernels       complete addition at 65,536 lanes through XLA and through
                the CUDA kernel, checked against host bignums and timed
                chained; a 2^15-point MSM (65,536 GLV lanes) through
                ``msm.run_msm``'s program against the exact host point
  cli           ``cli test --engine jax`` on examples/64bit and rec_test;
                proof bytes equal the host engine's
  aggregated    examples/128by64 proved and verified on the JaxEngine;
                bytes equal the host engine's
  serve         ProofServer warmed on the 32- and 64-bit schemas answers
                prove and verify requests over TCP; a tampered proof is
                ``valid: false``
  block_verify  1024 64-bit proofs (made on the host by CPU-only workers)
                batch-verified from wire bytes: honest block accepted, one
                tampered proof rejects it

``--four`` runs a ShardedJaxEngine over a ('win', 'pts') = (1, 4) mesh: a
sharded MSM at 2^17 lanes against the one-card result, and the 1024-proof
block through the mesh.

Exits non-zero, printing no result, off the GPU or when any phase fails.
The last line of a passing run is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 2024
MSM_POINTS = 1 << 15  # 65,536 GLV lanes
FOUR_MSM_POINTS = 1 << 16  # 2^17 GLV lanes
BLOCK_PROOFS = 1024


def _fail(msg: str):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def _gpu_visible() -> bool:
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and not any(p in plats for p in ("cuda", "gpu")):
        return False
    return shutil.which("nvidia-smi") is not None


class Phases:
    """Runs named phases, prints one JSON line each, remembers failures."""

    def __init__(self, jax):
        self.jax = jax
        self.failed = []
        self._compile_s = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in (
            "/jax/core/compile/jaxpr_trace_duration",
            "/jax/core/compile/jaxpr_to_mlir_module_duration",
            "/jax/core/compile/backend_compile_duration",
        ):
            self._compile_s += duration

    def run(self, name, fn, *args):
        facts = {}
        c0, t0 = self._compile_s, time.perf_counter()
        try:
            fn(facts, *args)
            ok = True
        except Exception:
            traceback.print_exc()
            ok = False
            self.failed.append(name)
        stats = self.jax.devices()[0].memory_stats() or {}
        line = {
            "phase": name,
            "ok": ok,
            "compile_s": round(self._compile_s - c0, 3),
            "wall_s": round(time.perf_counter() - t0, 3),
            "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
            **facts,
        }
        print(json.dumps(line), flush=True)


def _check(cond, what):
    if not cond:
        raise AssertionError(what)


def _timeit(jax, f, *args, reps=10):
    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _doubling_basis(n):
    """P_i = 2^i G (bench.py's MSM basis): the MSM's exact value is the
    single host scalar multiple (sum s_i 2^i mod R) G."""
    from bulletproofspp_tpu.core import ec

    pts, p = [], ec.G
    for _ in range(n):
        pts.append(p)
        p = ec.dbl(p)
    return pts


def _msm_inputs(n_points, seed):
    """Device lanes [P_i, phi(P_i)] and GLV digits for random scalars."""
    import jax.numpy as jnp

    from bulletproofspp_tpu import native
    from bulletproofspp_tpu.core import ec
    from bulletproofspp_tpu.core.fields import R
    from bulletproofspp_tpu.ops import curve, glv
    from bulletproofspp_tpu.ops.engine import _interleave_endo

    pts = _doubling_basis(n_points)
    rng = random.Random(seed)
    scalars = [rng.randrange(R) for _ in range(n_points)]
    nat = native.glv_recode_batch(scalars)
    if nat is None:
        halves = [h for s in scalars for h in glv.split(s)]
        nat = glv.recode_batch(halves)
    lanes = _interleave_endo(*curve.from_affine_host(pts))
    want = ec.scalar_mul(sum(s << i for i, s in enumerate(scalars)) % R, ec.G)
    return pts, lanes, (jnp.asarray(nat[0]), jnp.asarray(nat[1])), want


# -- phases -----------------------------------------------------------------


def phase_gpu_tests(facts):
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-p", "no:cacheprovider", "tests/"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    tail = r.stdout.strip().splitlines()[-1:] or [""]
    facts["pytest_rc"] = r.returncode
    facts["pytest_summary"] = tail[0]
    if r.returncode != 0:
        print(r.stdout[-6000:], r.stderr[-4000:], file=sys.stderr)
    _check(r.returncode == 0, "pytest -m gpu failed")
    _check(" passed" in tail[0] and "skipped" not in tail[0], "gpu tests skipped or did not run")


def phase_kernels(facts, jax):
    import jax.numpy as jnp
    from jax import lax

    from bulletproofspp_tpu.core import ec
    from bulletproofspp_tpu.ops import curve, limb, msm, padd_cuda

    n_points = MSM_POINTS
    pts, lanes, digits, want = _msm_inputs(n_points, SEED)
    L = 2 * n_points
    host_lanes = [h for q in pts for h in (q, ec.endo(q))]
    q_lanes = tuple(jnp.roll(t, 1, axis=1) for t in lanes)
    sample = list(range(0, L, max(1, L // 256))) + [1, L - 1]

    def exact(out):
        got = curve.to_affine_host(tuple(t[:, sample] for t in out))
        return got == [ec.add(host_lanes[i], host_lanes[i - 1]) for i in sample]

    chain = 8

    def chained(add):
        return jax.jit(lambda p, q: lax.fori_loop(0, chain, lambda _, acc: add(acc, q), p))

    xla_out = jax.jit(curve.padd)(lanes, q_lanes)
    kern_out = jax.jit(padd_cuda.padd)(lanes, q_lanes)
    _check(exact(xla_out), "XLA padd differs from host bignums")
    _check(exact(kern_out), "CUDA padd differs from host bignums")
    same = all(bool(jnp.all(limb.normalize(a) == limb.normalize(b))) for a, b in zip(xla_out, kern_out))
    _check(same, "CUDA padd differs from XLA padd")
    facts["padd_lanes"] = L
    facts["padd_chain"] = chain
    facts["padd_xla_chain_s"] = _timeit(jax, chained(curve.padd), lanes, q_lanes)
    facts["padd_cuda_chain_s"] = _timeit(jax, chained(padd_cuda.padd), lanes, q_lanes)

    t0 = time.perf_counter()
    compiled = msm._msm_compiled.lower(*lanes, *digits).compile()
    facts["msm_compile_s"] = round(time.perf_counter() - t0, 3)
    print(json.dumps({"msm_memory_analysis": str(compiled.memory_analysis())}), flush=True)
    hlo = compiled.as_text()
    floats = sum(hlo.count(t) for t in ("f16[", "bf16[", "f32[", "f64["))
    facts["msm_float_ops"] = floats
    _check(floats == 0, "a float op is on the MSM path")
    got = curve.to_affine_host(compiled(*lanes, *digits))[0]
    _check(got == want, "MSM differs from the exact host point")
    facts["msm_s"] = _timeit(jax, compiled, *lanes, *digits, reps=5)
    facts["msm_points"] = n_points


def _example(name):
    d = os.path.join(REPO, "examples", name)
    with open(os.path.join(d, "schema.json")) as f:
        schema = json.load(f)
    with open(os.path.join(d, "witness.json")) as f:
        witness = json.load(f)
    return d, schema, witness


def _host_bytes(schema, witness, seed=None):
    from bulletproofspp_tpu.cli import _resolve_values, load_points
    from bulletproofspp_tpu.core import range_proof as rpm
    from bulletproofspp_tpu.core.engine import HostEngine
    from bulletproofspp_tpu.io_ import schema as schema_mod

    spec = schema_mod.parse_spec(schema)
    setup = schema_mod.build_setup(spec, load_points(spec, schema_mod.points_needed(spec)))
    values = _resolve_values(spec, schema_mod.parse_witness(witness))
    seed = spec.random_seed.encode() if seed is None else seed
    return rpm.encode_proof(setup, rpm.prove(setup, values, seed, HostEngine()))


def _cli_test(name, facts):
    """``cli test --engine jax`` in this process; returns (commits, proof)."""
    from bulletproofspp_tpu import cli
    from bulletproofspp_tpu.core.engine import set_default_engine

    d, schema, witness = _example(name)
    with tempfile.TemporaryDirectory() as tmp:
        coms, proof = os.path.join(tmp, "commits.bin"), os.path.join(tmp, "proof.bin")
        set_default_engine(None)
        t0 = time.perf_counter()
        rc = cli.main(["test", os.path.join(d, "schema.json"), os.path.join(d, "witness.json"),
                       coms, proof, "--engine", "jax"])
        facts[f"{name}_cli_s"] = round(time.perf_counter() - t0, 3)
        set_default_engine(None)
        _check(rc == 0, f"cli test {name} exited {rc}")
        with open(coms, "rb") as f:
            c = f.read()
        with open(proof, "rb") as f:
            p = f.read()
    want = _host_bytes(schema, witness)
    _check((c, p) == want, f"{name}: JaxEngine proof bytes differ from HostEngine's")
    facts[f"{name}_proof_bytes"] = len(p)


def phase_cli(facts):
    for name in ("64bit", "rec_test"):
        _cli_test(name, facts)


def phase_aggregated(facts):
    _cli_test("128by64", facts)


def phase_serve(facts):
    from bulletproofspp_tpu.ops.engine import JaxEngine
    from bulletproofspp_tpu.serve import ProofServer, request

    schema32 = dict(_example("32bit")[1], randomSeed="smoke 32")
    schema64 = dict(_example("64bit")[1], randomSeed="smoke 64")
    w32, w64 = _example("32bit")[2], _example("64bit")[2]
    with ProofServer(engine=JaxEngine(), linger_ms=50, max_batch=4, max_verify_fuse=2) as srv:
        t0 = time.perf_counter()
        srv.service.warm([(schema32, w32), (schema64, w64)], sizes=(1, 2))
        facts["warm_s"] = round(time.perf_counter() - t0, 3)
        reqs = [
            {"op": "prove", "schema": s, "witness": w, "seed": f"smoke{i}".encode().hex()}
            for i, (s, w) in enumerate([(schema64, w64), (schema32, w32), (schema64, w64)])
        ]
        t0 = time.perf_counter()
        proved = request("127.0.0.1", srv.port, reqs)
        facts["prove_requests_s"] = round(time.perf_counter() - t0, 3)
        _check(all(r["ok"] for r in proved), f"prove failed: {proved}")
        c, p = _host_bytes(schema64, w64, seed=b"smoke0")
        _check(bytes.fromhex(proved[0]["proof"]) == p and bytes.fromhex(proved[0]["commits"]) == c,
               "served proof bytes differ from HostEngine's")
        bad = bytearray.fromhex(proved[2]["proof"])
        bad[50] ^= 1
        vreqs = [
            {"op": "verify", "schema": s, "commits": r["commits"], "proof": r["proof"]}
            for s, r in zip((schema64, schema32, schema64), proved)
        ] + [{"op": "verify", "schema": schema64, "commits": proved[2]["commits"], "proof": bad.hex()}]
        t0 = time.perf_counter()
        verdicts = request("127.0.0.1", srv.port, vreqs)
        facts["verify_requests_s"] = round(time.perf_counter() - t0, 3)
        stats = request("127.0.0.1", srv.port, [{"op": "stats"}])[0]
    valid = [r.get("valid") for r in verdicts]
    facts["verdicts"] = valid
    facts["batches"] = stats["batches"]
    _check(valid == [True, True, True, False], f"verify verdicts {verdicts}")


def _block(n=None):
    """The 1024-proof block of bench.py: wire bytes made on the host."""
    sys.path.insert(0, REPO)
    import bench
    from bulletproofspp_tpu.core.transcript import take_points
    from bulletproofspp_tpu.io_ import schema as schema_mod

    n = BLOCK_PROOFS if n is None else n
    spec = schema_mod.parse_spec(bench._BENCH64_SPEC)
    setup = schema_mod.build_setup(spec, take_points(spec.basis_seed.encode(), schema_mod.points_needed(spec)))
    blobs = bench._load_or_gen_proofs(n)
    honest = [(setup, c, p) for c, p in blobs]
    bad = bytearray(blobs[n // 2][1])
    bad[50] ^= 1
    tampered = list(honest)
    tampered[n // 2] = (setup, blobs[n // 2][0], bytes(bad))
    return honest, tampered


def _verify_block(facts, engine, tag):
    from bulletproofspp_tpu.core.batch import batch_verify_encoded

    t0 = time.perf_counter()
    honest, tampered = _block()
    facts["corpus_s"] = round(time.perf_counter() - t0, 3)
    for name, entries, want in (("honest", honest, True), ("tampered", tampered, False)):
        t0 = time.perf_counter()
        got = batch_verify_encoded(entries, engine)
        facts[f"{tag}_{name}_s"] = round(time.perf_counter() - t0, 3)
        _check(got is want, f"{tag} block ({name}) verified {got}")
    facts["block_proofs"] = len(honest)


def phase_block_verify(facts):
    from bulletproofspp_tpu.ops.engine import JaxEngine

    _verify_block(facts, JaxEngine(), "jax")


def phase_four(facts, jax):
    from bulletproofspp_tpu.ops import curve, msm, sharded
    from bulletproofspp_tpu.ops.engine import ShardedJaxEngine

    mesh = sharded.make_mesh(win=1)
    facts["mesh"] = dict(mesh.shape)
    _check(mesh.devices.size == 4, f"mesh has {mesh.devices.size} devices")
    _, lanes, digits, want = _msm_inputs(FOUR_MSM_POINTS, SEED + 1)
    step = sharded.sharded_msm_jit(mesh)
    absd, sgn = sharded.pad_rows(*digits, mesh.shape["win"])
    t0 = time.perf_counter()
    got4 = curve.to_affine_host(jax.block_until_ready(step(*lanes, absd, sgn)))[0]
    facts["sharded_msm_first_s"] = round(time.perf_counter() - t0, 3)
    got1 = curve.to_affine_host(msm.run_msm(*lanes, *digits))[0]
    _check(got4 == got1 == want, "sharded MSM differs from the one-card MSM or the host")
    facts["sharded_msm_s"] = _timeit(jax, step, *lanes, absd, sgn, reps=5)
    facts["one_card_msm_s"] = _timeit(jax, msm.run_msm, *lanes, *digits, reps=5)
    _verify_block(facts, ShardedJaxEngine(mesh=mesh), "sharded")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true", help="run the four-card sharded path only")
    args = ap.parse_args(argv)
    want_count = 4 if args.four else 1

    if not _gpu_visible():
        _fail("needs an NVIDIA GPU (no nvidia-smi, or JAX_PLATFORMS excludes cuda)")
    if not os.path.isdir(os.path.join(REPO, "bulletproofspp_tpu")):
        _fail("run from a checkout of the repository")
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        _fail(f"nvidia-smi failed: {r.stderr.strip()}")
    for line in r.stdout.strip().splitlines():
        print(line.strip(), flush=True)

    started = time.perf_counter()
    gpu_tests_line = None
    if not args.four:
        # the child must finish before this process opens the card
        facts = {}
        t0 = time.perf_counter()
        try:
            phase_gpu_tests(facts)
            ok = True
        except Exception:
            traceback.print_exc()
            ok = False
        gpu_tests_line = {"phase": "gpu_tests", "ok": ok, "compile_s": None,
                          "wall_s": round(time.perf_counter() - t0, 3),
                          "peak_bytes_in_use": None, **facts}

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        _fail(f"needs an NVIDIA GPU; JAX found {dev.platform!r}")
    count = len(jax.devices())
    if count < want_count:
        _fail(f"needs {want_count} GPUs; JAX found {count}")
    from bulletproofspp_tpu import native

    print(json.dumps({"device_kind": dev.device_kind, "device_count": count,
                      "native_lib_loaded": native.get_lib() is not None}), flush=True)

    phases = Phases(jax)
    if gpu_tests_line is not None:
        print(json.dumps(gpu_tests_line), flush=True)
        if not gpu_tests_line["ok"]:
            phases.failed.append("gpu_tests")
    if args.four:
        phases.run("four", phase_four, jax)
    else:
        phases.run("kernels", phase_kernels, jax)
        phases.run("cli", phase_cli)
        phases.run("aggregated", phase_aggregated)
        phases.run("serve", phase_serve)
        phases.run("block_verify", phase_block_verify)
    print(json.dumps({"total_s": round(time.perf_counter() - started, 3)}), flush=True)
    if phases.failed:
        _fail(f"failed phases: {phases.failed}")
    print(json.dumps({"ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
