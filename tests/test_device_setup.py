"""What happens around the device: the compile-cache path, the default
engine, refusal off the GPU, and one process per card."""

import os
import subprocess
import sys

import pytest

from bulletproofspp_tpu import ops
from bulletproofspp_tpu.core import engine as core_engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "env,want",
    [
        ({"JAX_COMPILATION_CACHE_DIR": "/somewhere/cache"}, "/somewhere/cache"),
        ({}, os.path.join(REPO, ".jax_cache")),
        ({"BPPP_NO_COMPILE_CACHE": "1"}, None),
    ],
)
def test_compile_cache_dir(monkeypatch, env, want):
    for k in ("JAX_COMPILATION_CACHE_DIR", "BPPP_NO_COMPILE_CACHE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert ops.compile_cache_dir() == want


def test_compile_cache_dir_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("choice", ["jax", "bogus"])
def test_default_engine_raises_instead_of_falling_back(monkeypatch, choice):
    from bulletproofspp_tpu.ops import engine as ops_engine

    def broken(self, *a, **k):
        raise RuntimeError("no device")

    monkeypatch.setattr(ops_engine.JaxEngine, "__init__", broken)
    monkeypatch.setattr(core_engine, "_default_engine", None)
    monkeypatch.setenv("BPPP_ENGINE", choice)
    with pytest.raises((RuntimeError, ValueError)):
        core_engine.default_engine()
    assert core_engine._default_engine is None


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_to_run_off_the_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, script)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0
    assert "needs an NVIDIA GPU" in r.stderr
    assert '"ok": true' not in r.stdout


def test_mp_prove_refuses_jax_parties_without_local(tmp_path, capsys):
    from bulletproofspp_tpu import cli

    ex = os.path.join(REPO, "examples", "32by64")
    rc = cli.main([
        "mp-prove", os.path.join(ex, "schema.json"), os.path.join(ex, "witness.json"),
        str(tmp_path / "c.bin"), str(tmp_path / "p.bin"),
        "--parties", "2", "--engine", "host", "--party-engine", "jax",
    ])
    assert rc == 2
    assert "--party-engine jax needs --local" in capsys.readouterr().err
    assert not (tmp_path / "p.bin").exists()
