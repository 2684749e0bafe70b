// Shared helpers for the EP kernels: dtype codes, row loads and stores of
// eight elements at a time, and the fp8 block quantizer.
//
// The dtype codes match repro_torch/kernels/_build.py DTYPE_CODES.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum DType : int { F32 = 0, BF16 = 1, F16 = 2, FP8E4M3 = 3 };

__host__ __device__ inline int dtype_size(int dt) {
  return dt == F32 ? 4 : (dt == FP8E4M3 ? 1 : 2);
}

__device__ inline float load_elem(const void* p, int64_t i, int dt) {
  switch (dt) {
    case F32: return static_cast<const float*>(p)[i];
    case BF16: return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case F16: return __half2float(static_cast<const __half*>(p)[i]);
    default: {
      __half_raw h = __nv_cvt_fp8_to_halfraw(
          static_cast<const __nv_fp8_storage_t*>(p)[i], __NV_E4M3);
      return __half2float(__half(h));
    }
  }
}

// Round-to-nearest-even to the storage type (torch's .to(dtype) rounding).
__device__ inline void store_elem(void* p, int64_t i, int dt, float v) {
  switch (dt) {
    case F32: static_cast<float*>(p)[i] = v; break;
    case BF16: static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v); break;
    case F16: static_cast<__half*>(p)[i] = __float2half(v); break;
    default:
      static_cast<__nv_fp8_storage_t*>(p)[i] =
          __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
  }
}

// Eight consecutive elements starting at element i (i % 8 == 0), read with
// 16-byte loads where the type allows. The caller guarantees the row start
// is 16-byte aligned (fp8: 8-byte) and the row width is a multiple of 8.
__device__ inline void load8(const void* p, int64_t i, int dt, float v[8]) {
  if (dt == BF16) {
    uint4 u = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p) + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else if (dt == F32) {
    const float4* q = reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
    float4 a = q[0], b = q[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = load_elem(p, i + j, dt);
  }
}

__device__ inline void store8(void* p, int64_t i, int dt, const float v[8]) {
  if (dt == BF16) {
    uint4 u;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) h[j] = __float2bfloat16(v[j]);
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p) + i) = u;
  } else if (dt == F32) {
    float4* q = reinterpret_cast<float4*>(static_cast<float*>(p) + i);
    q[0] = make_float4(v[0], v[1], v[2], v[3]);
    q[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) store_elem(p, i + j, dt, v[j]);
  }
}

// Block-wise fp8 e4m3 quantization of the `qb` elements at element `base` of
// src (dtype sdt) into dst, by one warp: amax over the block by shuffles,
// scale = amax / 448 (1 for an all-zero block), each element divided by the
// scale and rounded to e4m3 with satfinite. A true division, never a
// multiply by 1/scale, keeps the plain version's bits. Returns the scale in
// every lane. quantize_fp8 calls it, and dispatch_pack's quant mode for a
// block width that is not 8 * 2^k (its own lane-group path computes the same
// max, division and rounding for the rest). With `vec` (qb % 8 == 0, a 16-byte aligned
// source row, an 8-byte aligned dst) a lane takes eight elements at a time
// and stores their eight bytes at once.
__device__ inline float quant_block_warp(const void* src, int64_t base, int qb,
                                         int sdt, __nv_fp8_storage_t* dst,
                                         bool vec) {
  const int lane = threadIdx.x % 32;
  float amax = 0.f;
  if (vec) {
    for (int j = lane * 8; j < qb; j += 32 * 8) {
      float v[8];
      load8(src, base + j, sdt, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) amax = fmaxf(amax, fabsf(v[k]));
    }
  } else {
    for (int j = lane; j < qb; j += 32)
      amax = fmaxf(amax, fabsf(load_elem(src, base + j, sdt)));
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = amax > 0.f ? amax / 448.f : 1.f;
  if (vec) {
    for (int j = lane * 8; j < qb; j += 32 * 8) {
      float v[8];
      load8(src, base + j, sdt, v);
      uint2 u;
      __nv_fp8_storage_t* b = reinterpret_cast<__nv_fp8_storage_t*>(&u);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        b[k] = __nv_cvt_float_to_fp8(v[k] / scale, __NV_SATFINITE, __NV_E4M3);
      *reinterpret_cast<uint2*>(dst + base + j) = u;
    }
  } else {
    for (int j = lane; j < qb; j += 32)
      dst[base + j] = __nv_cvt_float_to_fp8(load_elem(src, base + j, sdt) / scale,
                                            __NV_SATFINITE, __NV_E4M3);
  }
  return scale;
}
