// combine_gather_reduce: out[t] = sum_k w[t, k] * recv[rows[t, k]], summed in
// f32 and cast once, without building the [T, K, H] gathered tensor.
//
// Replaces src/repro/kernels/combine_gather_reduce.py:44 combine_gather_reduce
// (the Pallas kernel that revisits one VMEM tile over a sequential k grid
// axis). Bound by bytes: K row reads and one row write per token. What the
// design does about each cost of the first kernel (one block of 128 threads
// per (token, 1024-wide tile) walking k with an index load, a row load and an
// FMA in a chain: 7.7x its bound at DBRX's decode combine on an H100):
//
// - Round trips. A thread owns one 16-byte piece of one token's output (8
//   bf16 or f16 values, 4 f32). It reads the token's K row indices and
//   weights once (one int4 and one float4 load where K = 4 and both arrays
//   are 16-byte aligned, else scalar loads), then issues the 16-byte loads
//   of all its rows (up to 8 at a time, so every row of K <= 8) before the
//   first FMA: two dependent trips to memory a call instead of 2K.
// - Filling the card. Blocks of 64 threads over (token, tile of 64 pieces):
//   the decode combine (16 tokens, H 6144 bf16) has 192 blocks, more than
//   the card's 132 SMs.
// - Order. Each thread sums in f32 over k = 0..K-1 in that fixed order and
//   rounds once, so two calls give the same bits and a token's bits depend
//   only on its own rows and weights. A sentinel row (outside [0, R)) is not
//   loaded and adds nothing.
#include "common.cuh"

namespace {

constexpr int GR_THREADS = 64;

// One 16-byte piece of dtype DT to f32 and back (round-to-nearest-even).
template <int DT>
struct PieceOf;
template <>
struct PieceOf<F32> {
  static constexpr int E = 4;
  __device__ static void load(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 store(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <>
struct PieceOf<BF16> {
  static constexpr int E = 8;
  __device__ static void load(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 p = __bfloat1622float2(h[j]);
      f[2 * j] = p.x;
      f[2 * j + 1] = p.y;
    }
  }
  __device__ static uint4 store(const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    return u;
  }
};
template <>
struct PieceOf<F16> {
  static constexpr int E = 8;
  __device__ static void load(const uint4& u, float* f) {
    const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 p = __half22float2(h[j]);
      f[2 * j] = p.x;
      f[2 * j + 1] = p.y;
    }
  }
  __device__ static uint4 store(const float* f) {
    uint4 u;
    __half2* h = reinterpret_cast<__half2*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2half2_rn(f[2 * j], f[2 * j + 1]);
    return u;
  }
};

// KC rows in flight a thread; vec4: K == 4 with 16-byte aligned rows and w.
template <int DT, int KC>
__global__ void __launch_bounds__(GR_THREADS) gather_reduce_kernel(
    const uint4* __restrict__ recv, const int* __restrict__ rows, const float* __restrict__ w,
    uint4* __restrict__ out, int R, int64_t pieces, int K, bool vec4) {
  using Pc = PieceOf<DT>;
  const int64_t t = blockIdx.x;
  const int64_t p = static_cast<int64_t>(blockIdx.y) * GR_THREADS + threadIdx.x;
  if (p >= pieces) return;
  const int* rt = rows + t * K;
  const float* wt = w + t * K;
  float acc[Pc::E];
#pragma unroll
  for (int j = 0; j < Pc::E; ++j) acc[j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += KC) {
    int idx[KC];
    float wk[KC];
    if (KC == 4 && vec4) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(rt));
      const float4 b = __ldg(reinterpret_cast<const float4*>(wt));
      idx[0] = a.x; idx[1] = a.y; idx[2] = a.z; idx[3] = a.w;
      wk[0] = b.x; wk[1] = b.y; wk[2] = b.z; wk[3] = b.w;
    } else {
#pragma unroll
      for (int u = 0; u < KC; ++u) {
        const bool in = k0 + u < K;
        idx[u] = in ? __ldg(rt + k0 + u) : -1;
        wk[u] = in ? __ldg(wt + k0 + u) : 0.f;
      }
    }
    uint4 v[KC];
#pragma unroll
    for (int u = 0; u < KC; ++u)
      if (idx[u] >= 0 && idx[u] < R)
        v[u] = __ldg(recv + static_cast<int64_t>(idx[u]) * pieces + p);
#pragma unroll
    for (int u = 0; u < KC; ++u) {
      if (idx[u] < 0 || idx[u] >= R) continue;
      float f[Pc::E];
      Pc::load(v[u], f);
#pragma unroll
      for (int j = 0; j < Pc::E; ++j) acc[j] += wk[u] * f[j];
    }
  }
  out[t * pieces + p] = Pc::store(acc);
}

template <int DT>
void launch_reduce(const void* recv, const int* rows, const float* w, void* out, int T,
                   int R, int64_t H, int K, cudaStream_t st) {
  const int64_t pieces = H * dtype_size(DT) / 16;
  const dim3 grid(static_cast<unsigned>(T),
                  static_cast<unsigned>((pieces + GR_THREADS - 1) / GR_THREADS));
  const bool vec4 = K == 4 && reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const uint4* r = static_cast<const uint4*>(recv);
  uint4* o = static_cast<uint4*>(out);
  if (K <= 4)
    gather_reduce_kernel<DT, 4><<<grid, GR_THREADS, 0, st>>>(r, rows, w, o, R, pieces, K, vec4);
  else
    gather_reduce_kernel<DT, 8><<<grid, GR_THREADS, 0, st>>>(r, rows, w, o, R, pieces, K, false);
}

}  // namespace

// The output has the input's dtype; the wrapper guarantees H % 8 == 0 and a
// 16-byte aligned recv.
extern "C" int ep_combine_gather_reduce(const void* recv, const void* rows,
                                        const void* w, void* out, int T, int R,
                                        int64_t H, int K, int dt, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rows);
  const float* wf = static_cast<const float*>(w);
  if (T > 0 && H > 0) {               // K == 0 writes zero rows
    switch (dt) {
      case F32: launch_reduce<F32>(recv, r, wf, out, T, R, H, K, st); break;
      case BF16: launch_reduce<BF16>(recv, r, wf, out, T, R, H, K, st); break;
      case F16: launch_reduce<F16>(recv, r, wf, out, T, R, H, K, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
