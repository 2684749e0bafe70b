// Shared helpers for the EP kernels: dtype codes, row loads and stores of
// eight elements at a time, and the row copy used by the two gathers.
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

// Copy one row of `width` elements from src (dtype sdt) to dst (dtype ddt),
// the whole block cooperating. src == nullptr writes a zero row. Same-dtype
// rows move as raw bytes (16 at a time when `vec`), so the copy is exact;
// a dtype change converts through f32 with round-to-nearest-even.
__device__ inline void copy_row(const void* src, int sdt, void* dst, int ddt,
                                int64_t width, bool vec) {
  if (src != nullptr && sdt == ddt) {
    int64_t nbytes = width * dtype_size(sdt);
    const char* s = static_cast<const char*>(src);
    char* d = static_cast<char*>(dst);
    if (vec && nbytes % 16 == 0) {
      for (int64_t b = threadIdx.x * 16; b < nbytes; b += blockDim.x * 16)
        *reinterpret_cast<uint4*>(d + b) = *reinterpret_cast<const uint4*>(s + b);
    } else {
      for (int64_t b = threadIdx.x; b < nbytes; b += blockDim.x) d[b] = s[b];
    }
    return;
  }
  if (vec) {
    for (int64_t i = threadIdx.x * 8; i < width; i += blockDim.x * 8) {
      float v[8];
      if (src != nullptr) {
        load8(src, i, sdt, v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.f;
      }
      store8(dst, i, ddt, v);
    }
  } else {
    for (int64_t i = threadIdx.x; i < width; i += blockDim.x)
      store_elem(dst, i, ddt, src != nullptr ? load_elem(src, i, sdt) : 0.f);
  }
}
