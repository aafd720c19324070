"""The complete addition as a CUDA kernel (native/bppp_padd.cu).

XLA's version of ``curve.padd`` is about 40 elementwise field operations
on 16-bit limb planes; on the GPU it compiles to hundreds of small
kernels whose intermediates round-trip through device memory, and every
copy of it inside a jitted program costs compile time.  The CUDA kernel
does one lane per thread with 32-bit limbs and 64-bit products, and is
compiled once, by nvcc, for every shape: the lane count is a run-time
argument.

The library is built from the committed source at first use into
``native/`` (gitignored), keyed by a hash of the source, and registered
as the XLA FFI target ``bppp_padd``.  On the CPU backend the same source
is built with g++ into a host loop behind the same handler, so the CPU
tests run this wrapper, its batching and the kernel's arithmetic; the
system itself uses ``curve.padd`` there (``curve.use_padd_kernel``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "bppp_padd.cu",
)
_TARGET = "bppp_padd"
_lock = threading.Lock()
_registered = False


def _build(flavour: str) -> str:
    """Compile the source ("cuda" with nvcc, "host" with g++); returns the
    shared object's path.  Raises with the compiler's output on failure."""
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(os.path.dirname(_SRC), f"bppp_padd-{flavour}-{tag}.so")
    if os.path.exists(so):
        return so
    tmp = f"{so}.tmp.{os.getpid()}"
    include = jax.ffi.include_dir()
    if flavour == "cuda":
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-I", include, "-o", tmp, _SRC]
    else:
        cmd = ["g++", "-std=c++17", "-O2", "-shared", "-fPIC", "-I", include,
               "-x", "c++", "-o", tmp, _SRC]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"building {_SRC} failed:\n{r.stdout}\n{r.stderr}")
    os.replace(tmp, so)  # atomic: concurrent builders race benignly
    return so


_FLAVOURS = {"gpu": ("cuda", "CUDA"), "cpu": ("host", "cpu")}


def _register():
    global _registered
    with _lock:
        if not _registered:
            flavour, platform = _FLAVOURS[jax.default_backend()]
            lib = ctypes.cdll.LoadLibrary(_build(flavour))
            jax.ffi.register_ffi_target(_TARGET, jax.ffi.pycapsule(lib.BpppPadd), platform=platform)
            _registered = True


def padd(p, q):
    """Complete addition of projective points whose coordinates are
    (16, ...) uint32 limb planes; any trailing shape, vmap-safe (batch
    axes go in front, which the kernel's (batch..., 16, n) layout takes)."""
    _register()
    shape = p[0].shape
    n = int(np.prod(shape[1:]))
    out = jax.ShapeDtypeStruct(shape, jnp.uint32)
    call = jax.ffi.ffi_call(_TARGET, (out, out, out), vmap_method="broadcast_all")
    return tuple(call(*p, *q, n=np.int64(n)))
