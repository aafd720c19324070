"""Bulletproofs++ — a JAX zero-knowledge range-proof framework for NVIDIA GPUs.

A from-scratch reimplementation of the capabilities of the Haskell
reference (Liam-Eagen/BulletproofsPP) designed for batched accelerator work:

- secp256k1 field/curve arithmetic as batched limb-decomposed JAX/Pallas
  kernels (``bulletproofspp_tpu.ops``),
- vectorized multi-scalar multiplication, shardable across device meshes
  (``bulletproofspp_tpu.ops.msm``, ``bulletproofspp_tpu.parallel``),
- the recursive norm / weighted-inner-product arguments and the binary /
  typed-reciprocal range proofs (``bulletproofspp_tpu.core``),
- a host-side Fiat-Shamir transcript that is bit-exact with the reference
  CLI (``bulletproofspp_tpu.core.transcript``).

Layering (mirrors SURVEY.md §1):
  ops.field_ops / ops.curve_ops / ops.msm   — device kernels (L0-L3)
  core.fields / core.ec                     — host ground-truth (L0-L2)
  core.transcript / core.encoding           — L4 / L7
  core.bulletproof / core.norm_linear / core.inner_product — L5
  core.binary_rp / core.typed_reciprocal    — L6
  io_.schema / cli                          — L8
"""

__version__ = "0.1.0"
