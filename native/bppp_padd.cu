// Complete point addition on secp256k1 for NVIDIA GPUs, called from JAX
// through the XLA foreign function interface (ops/padd_cuda.py).
//
// One thread per lane.  Points arrive as the JAX side stores them:
// projective (X, Y, Z) planes of shape (batch..., 16, n) uint32 with 16-bit
// limbs, limb k of lane i at offset 16*n*b + k*n + i (coalesced across
// threads).  A thread packs its coordinates into 8 x 32-bit limbs, runs
// the Renes-Costello-Batina complete addition for a = 0 (the algebra of
// ops/curve.py: padd) with 64-bit products, and writes 16-bit limbs back.
// Outputs keep the limb format of ops/limb.py: every limb < 2^16, value
// < 2^256 and congruent mod p, not necessarily canonical.
//
// Compiled without nvcc (g++ -x c++), the same arithmetic and layout run
// as a host loop behind the same FFI handler name, registered for the CPU
// platform, which is how the CPU tests check them against the XLA
// reference and host bignums.
//
// p = 2^256 - C with C = 2^32 + 977.

#include <cstdint>

#ifdef __CUDACC__
#define BPPP_FN __host__ __device__ __forceinline__
#else
#define BPPP_FN static inline
#endif

typedef uint32_t u32;
typedef uint64_t u64;

// limbs of 2p - 2^256 + 1: a - b == a + ~b + K2 (mod p), ~b = 2^256 - 1 - b
#define K2_0 0xfffff85fu
#define K2_1 0xfffffffdu
#define K2_REST 0xffffffffu

// r (value < 2^256) + top * 2^256, top < 2^35  ->  r < 2^256, same value mod p.
// 2^256 = C (mod p): add top * 977 at limb 0 and top at limb 1.  The carry
// out of limb 7 is then 0 or 1, and when it is 1 the remainder is below
// top * C < 2^68, so adding C once more cannot carry past limb 2.
BPPP_FN void fold_top(u32 r[8], u64 top) {
  u64 a = top * 977u;
  u64 v = (u64)r[0] + (a & 0xffffffffu);
  r[0] = (u32)v;
  v = (u64)r[1] + (a >> 32) + (top & 0xffffffffu) + (v >> 32);
  r[1] = (u32)v;
  v = (u64)r[2] + (top >> 32) + (v >> 32);
  r[2] = (u32)v;
  u64 c = v >> 32;
#pragma unroll
  for (int i = 3; i < 8; ++i) {
    v = (u64)r[i] + c;
    r[i] = (u32)v;
    c = v >> 32;
  }
  v = (u64)r[0] + c * 977u;
  r[0] = (u32)v;
  v = (u64)r[1] + c + (v >> 32);
  r[1] = (u32)v;
  r[2] += (u32)(v >> 32);
}

BPPP_FN void fadd(const u32 a[8], const u32 b[8], u32 r[8]) {
  u64 c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    u64 v = (u64)a[i] + b[i] + c;
    r[i] = (u32)v;
    c = v >> 32;
  }
  fold_top(r, c);
}

BPPP_FN void fsub(const u32 a[8], const u32 b[8], u32 r[8]) {
  u64 c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    u32 k = i == 0 ? K2_0 : (i == 1 ? K2_1 : K2_REST);
    u64 v = (u64)a[i] + (u32)~b[i] + k + c;
    r[i] = (u32)v;
    c = v >> 32;  // value < 3 * 2^256: c <= 2
  }
  fold_top(r, c);
}

BPPP_FN void fmul_small(const u32 a[8], u32 k, u32 r[8]) {
  u64 c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    u64 v = (u64)a[i] * k + c;
    r[i] = (u32)v;
    c = v >> 32;
  }
  fold_top(r, c);
}

BPPP_FN void fmul(const u32 a[8], const u32 b[8], u32 r[8]) {
  u32 t[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      u64 v = (u64)a[i] * b[j] + t[i + j] + c;  // <= 2^64 - 1
      t[i + j] = (u32)v;
      c = v >> 32;
    }
    t[i + 8] = (u32)c;
  }
  // low + high * 2^256 with 2^256 = 977 + 2^32 (mod p)
  u64 c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    u64 v = (u64)t[i] + (u64)t[8 + i] * 977u + c;
    if (i > 0) v += t[7 + i];
    r[i] = (u32)v;
    c = v >> 32;
  }
  fold_top(r, c + t[15]);  // t[15] lands at 2^256 through the 2^32 term
}

// RCB 2015, Algorithm 7 for a = 0, b3 = 21 (same sequence as curve.padd).
BPPP_FN void padd8(const u32 x1[8], const u32 y1[8], const u32 z1[8],
                   const u32 x2[8], const u32 y2[8], const u32 z2[8],
                   u32 x3[8], u32 y3[8], u32 z3[8]) {
  u32 t0[8], t1[8], t2[8], t3[8], t4[8], t5[8], u[8], w[8];
  fmul(x1, x2, t0);
  fmul(y1, y2, t1);
  fmul(z1, z2, t2);
  fadd(x1, y1, u);
  fadd(x2, y2, w);
  fmul(u, w, t3);
  fadd(t0, t1, u);
  fsub(t3, u, t3);  // X1Y2 + X2Y1
  fadd(y1, z1, u);
  fadd(y2, z2, w);
  fmul(u, w, t4);
  fadd(t1, t2, u);
  fsub(t4, u, t4);  // Y1Z2 + Y2Z1
  fadd(x1, z1, u);
  fadd(x2, z2, w);
  fmul(u, w, t5);
  fadd(t0, t2, u);
  fsub(t5, u, t5);  // X1Z2 + X2Z1
  fadd(t0, t0, u);
  fadd(u, t0, t0);  // t0 = 3 X1X2
  fmul_small(t2, 21, t2);  // t2 = b3 Z1Z2
  fadd(t1, t2, u);  // z3t
  fsub(t1, t2, t1);  // t1m
  fmul_small(t5, 21, t5);  // y3b
  fmul(t3, t1, w);
  fmul(t4, t5, t2);
  fsub(w, t2, x3);
  fmul(t5, t0, w);
  fmul(t1, u, t2);
  fadd(w, t2, y3);
  fmul(u, t4, w);
  fmul(t0, t3, t2);
  fadd(w, t2, z3);
}

BPPP_FN void load8(const u32* p, int64_t base, int64_t n, u32 out[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k] = p[base + (2 * k) * n] | (p[base + (2 * k + 1) * n] << 16);
}

BPPP_FN void store8(u32* p, int64_t base, int64_t n, const u32 v[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    p[base + (2 * k) * n] = v[k] & 0xffffu;
    p[base + (2 * k + 1) * n] = v[k] >> 16;
  }
}

// lane g of `lanes` = batch * n lanes
BPPP_FN void padd_lane(const u32* x1, const u32* y1, const u32* z1, const u32* x2,
                       const u32* y2, const u32* z2, u32* ox, u32* oy, u32* oz,
                       int64_t n, int64_t g) {
  int64_t b = g / n;
  int64_t base = b * 16 * n + (g - b * n);
  u32 a[8], bb[8], c[8], d[8], e[8], f[8], rx[8], ry[8], rz[8];
  load8(x1, base, n, a);
  load8(y1, base, n, bb);
  load8(z1, base, n, c);
  load8(x2, base, n, d);
  load8(y2, base, n, e);
  load8(z2, base, n, f);
  padd8(a, bb, c, d, e, f, rx, ry, rz);
  store8(ox, base, n, rx);
  store8(oy, base, n, ry);
  store8(oz, base, n, rz);
}

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

// planes are (batch..., 16, n): the lane count is elems / 16
static bool bad_layout(int64_t elems, int64_t n) { return n <= 0 || elems % (16 * n) != 0; }

#ifdef __CUDACC__

#include <cuda_runtime.h>

__global__ void padd_kernel(const u32* x1, const u32* y1, const u32* z1, const u32* x2,
                            const u32* y2, const u32* z2, u32* ox, u32* oy, u32* oz,
                            int64_t n, int64_t lanes) {
  int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g < lanes) padd_lane(x1, y1, z1, x2, y2, z2, ox, oy, oz, n, g);
}

static ffi::Error PaddImpl(cudaStream_t stream, int64_t n,
                           ffi::Buffer<ffi::U32> x1, ffi::Buffer<ffi::U32> y1,
                           ffi::Buffer<ffi::U32> z1, ffi::Buffer<ffi::U32> x2,
                           ffi::Buffer<ffi::U32> y2, ffi::Buffer<ffi::U32> z2,
                           ffi::ResultBuffer<ffi::U32> ox, ffi::ResultBuffer<ffi::U32> oy,
                           ffi::ResultBuffer<ffi::U32> oz) {
  int64_t elems = (int64_t)x1.element_count();
  if (bad_layout(elems, n)) return ffi::Error::InvalidArgument("bppp_padd: planes are not (batch..., 16, n)");
  int64_t lanes = elems / 16;
  if (lanes == 0) return ffi::Error::Success();
  const int threads = 128;
  int64_t blocks = (lanes + threads - 1) / threads;
  padd_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      x1.typed_data(), y1.typed_data(), z1.typed_data(), x2.typed_data(), y2.typed_data(),
      z2.typed_data(), ox->typed_data(), oy->typed_data(), oz->typed_data(), n, lanes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

#define BPPP_BIND ffi::Ffi::Bind().Ctx<ffi::PlatformStream<cudaStream_t>>()

#else

static ffi::Error PaddImpl(int64_t n, ffi::Buffer<ffi::U32> x1, ffi::Buffer<ffi::U32> y1,
                           ffi::Buffer<ffi::U32> z1, ffi::Buffer<ffi::U32> x2,
                           ffi::Buffer<ffi::U32> y2, ffi::Buffer<ffi::U32> z2,
                           ffi::ResultBuffer<ffi::U32> ox, ffi::ResultBuffer<ffi::U32> oy,
                           ffi::ResultBuffer<ffi::U32> oz) {
  int64_t elems = (int64_t)x1.element_count();
  if (bad_layout(elems, n)) return ffi::Error::InvalidArgument("bppp_padd: planes are not (batch..., 16, n)");
  for (int64_t g = 0; g < elems / 16; ++g) {
    padd_lane(x1.typed_data(), y1.typed_data(), z1.typed_data(), x2.typed_data(),
              y2.typed_data(), z2.typed_data(), ox->typed_data(), oy->typed_data(),
              oz->typed_data(), n, g);
  }
  return ffi::Error::Success();
}

#define BPPP_BIND ffi::Ffi::Bind()

#endif

XLA_FFI_DEFINE_HANDLER_SYMBOL(BpppPadd, PaddImpl,
                              BPPP_BIND.Attr<int64_t>("n")
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>());
