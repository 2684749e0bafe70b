// The row gather that dispatch_pack's copy mode (B1) and recv_unpack's copy
// mode (B2) share: out[r] = x[gmap[r]] for r < rows, a zero row where the
// index falls outside [0, n). A grid over (output row, chunk of
// GATHER_CHUNK units): each thread reads its row's index, issues all
// GATHER_UNROLL of its loads, then its stores, so a decode call has every
// load in flight in the first wave; a sentinel row stores zeros without a
// load. The kernels sit in an anonymous namespace: each of the two sources
// that include this header compiles its own copy of the same code.
#pragma once

#include "common.cuh"

namespace {

constexpr int GATHER_THREADS = 128;
constexpr int GATHER_UNROLL = 6;       // units per thread, all loaded before any store
constexpr int GATHER_CHUNK = GATHER_THREADS * GATHER_UNROLL;

// Same dtype: a row is `pieces` 16-byte pieces, moved raw (exact).
__global__ void __launch_bounds__(GATHER_THREADS) gather_copy_kernel(
    const uint4* __restrict__ x, const int* __restrict__ gmap, uint4* __restrict__ out, int n,
    int64_t pieces) {
  const int64_t r = blockIdx.x;
  const int src = __ldg(gmap + r);
  const int64_t base = static_cast<int64_t>(blockIdx.y) * GATHER_CHUNK + threadIdx.x;
  uint4* orow = out + r * pieces;
  uint4 v[GATHER_UNROLL];
  if (src >= 0 && src < n) {
    const uint4* xrow = x + static_cast<int64_t>(src) * pieces;
#pragma unroll
    for (int u = 0; u < GATHER_UNROLL; ++u) {
      const int64_t i = base + u * GATHER_THREADS;
      if (i < pieces) v[u] = __ldg(xrow + i);
    }
  } else {
#pragma unroll
    for (int u = 0; u < GATHER_UNROLL; ++u) v[u] = make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int u = 0; u < GATHER_UNROLL; ++u) {
    const int64_t i = base + u * GATHER_THREADS;
    if (i < pieces) orow[i] = v[u];
  }
}

// A dtype change: `H / 8` groups of 8 elements a row, each through f32 with
// round-to-nearest-even (load8 / store8).
__global__ void __launch_bounds__(GATHER_THREADS) gather_convert_kernel(
    const void* __restrict__ x, const int* __restrict__ gmap, void* __restrict__ out, int n,
    int64_t H, int xdt, int odt) {
  const int64_t r = blockIdx.x;
  const int src = __ldg(gmap + r);
  const int64_t units = H / 8;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * GATHER_CHUNK + threadIdx.x;
  const bool live = src >= 0 && src < n;
  const char* xrow = static_cast<const char*>(x) + static_cast<int64_t>(live ? src : 0) * H *
                                                       dtype_size(xdt);
  char* orow = static_cast<char*>(out) + r * H * dtype_size(odt);
  float v[GATHER_UNROLL][8];
#pragma unroll
  for (int u = 0; u < GATHER_UNROLL; ++u) {
    const int64_t i = base + u * GATHER_THREADS;
    if (live && i < units) {
      load8(xrow, i * 8, xdt, v[u]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[u][k] = 0.f;
    }
  }
#pragma unroll
  for (int u = 0; u < GATHER_UNROLL; ++u) {
    const int64_t i = base + u * GATHER_THREADS;
    if (i < units) store8(orow, i * 8, odt, v[u]);
  }
}

// Launch the gather of `rows` output rows of H elements. The caller
// guarantees H % 8 == 0, 16-byte aligned x and out and, for an unchanged
// dtype, rows of whole 16-byte pieces.
inline int gather_rows(const void* x, const int* gmap, void* out, int64_t rows, int n,
                       int64_t H, int xdt, int odt, cudaStream_t st) {
  if (rows <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (xdt == odt) {
    const int64_t pieces = H * dtype_size(xdt) / 16;
    dim3 grid(static_cast<unsigned>(rows),
              static_cast<unsigned>((pieces + GATHER_CHUNK - 1) / GATHER_CHUNK));
    gather_copy_kernel<<<grid, GATHER_THREADS, 0, st>>>(static_cast<const uint4*>(x), gmap,
                                                        static_cast<uint4*>(out), n, pieces);
  } else {
    dim3 grid(static_cast<unsigned>(rows),
              static_cast<unsigned>((H / 8 + GATHER_CHUNK - 1) / GATHER_CHUNK));
    gather_convert_kernel<<<grid, GATHER_THREADS, 0, st>>>(x, gmap, out, n, H, xdt, odt);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
