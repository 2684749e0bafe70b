// The weighted row reduce that combine_gather_reduce (B4) and combine_reduce
// (B8) share: out[t] = sum_k w[t, k] * in[row(t, k)], summed in f32 over
// k = 0..K-1 in that fixed order and rounded once. The two differ only in
// where token t's K rows come from (IndexRows, TokenRows below) and in the
// weights' dtype, template parameters, so each compiles its own copy of the
// same code. The kernels sit in an anonymous namespace, as in gather.cuh.
//
// A thread owns one 16-byte piece of one token's output (8 bf16 or f16
// values, 4 f32). It reads the token's K weights, and B4's K row indices,
// once (B4: one int4 and one float4 load where K = 4 and both arrays are
// 16-byte aligned), then issues the loads of all its rows (up to 8 at a
// time, so every row of K <= 8) before the first FMA: two dependent trips to
// memory a call instead of 2K. Blocks of 64 threads over (token, tile of 64
// pieces): a decode call (16 tokens, H 6144 bf16) has 192 blocks, more than
// the card's 132 SMs. Two calls give the same bits, and a token's bits
// depend only on its own rows and weights.
#pragma once

#include "common.cuh"

namespace {

constexpr int GR_THREADS = 64;

// One piece of dtype DT: E elements in a Raw word, to f32 and back
// (round-to-nearest-even). An input piece and its output piece hold the same
// E elements: fp8 in 8 bytes for 8 bf16 out in 16.
template <int DT>
struct PieceOf;
template <>
struct PieceOf<F32> {
  using Raw = uint4;
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
  using Raw = uint4;
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
  using Raw = uint4;
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
template <>
struct PieceOf<FP8E4M3> {                  // input only (e4m3 to half is exact)
  using Raw = uint2;
  static constexpr int E = 8;
  __device__ static void load(const uint2& u, float* f) {
    const __nv_fp8x2_storage_t* b = reinterpret_cast<const __nv_fp8x2_storage_t*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 p = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(b[j], __NV_E4M3)));
      f[2 * j] = p.x;
      f[2 * j + 1] = p.y;
    }
  }
};

__device__ inline float weight_f32(float v) { return v; }
__device__ inline float weight_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ inline float weight_f32(__half v) { return __half2float(v); }

// A row source fetches token t's rows k0 .. k0 + KC - 1 (index -1 past K)
// and their weights in f32 (0 past K).

// B4: token t's K rows are given, rows [T, K] int32; an index outside [0, R)
// is a sentinel, not loaded, adding nothing. Weights f32; vec4: K == 4 with
// rows and weights 16-byte aligned, one int4 and one float4 load.
struct IndexRows {
  using Index = int;
  const int* rows;
  int R;
  template <int KC>
  __device__ void fetch(int64_t t, int k0, int K, bool vec4, const float* w, Index idx[KC],
                        float wk[KC]) const {
    const int* rt = rows + t * K;
    const float* wt = w + t * K;
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
  }
  __device__ bool live(Index i) const { return i >= 0 && i < R; }
};

// B8: token t's rows are rows t * K .. t * K + K - 1 of y [T, K, H] viewed as
// [T * K, H]; no index load, no sentinel. Weights f32, bf16 or f16, read in
// their own dtype.
struct TokenRows {
  using Index = int64_t;
  template <int KC, class W>
  __device__ void fetch(int64_t t, int k0, int K, bool, const W* w, Index idx[KC],
                        float wk[KC]) const {
#pragma unroll
    for (int u = 0; u < KC; ++u) {
      const bool in = k0 + u < K;
      idx[u] = in ? t * K + k0 + u : -1;
      wk[u] = in ? weight_f32(__ldg(w + t * K + k0 + u)) : 0.f;
    }
  }
  __device__ bool live(Index i) const { return i >= 0; }
};

// KC rows in flight a thread.
template <class In, class Out, int KC, class Rows, class W>
__global__ void __launch_bounds__(GR_THREADS) reduce_rows_kernel(
    const typename In::Raw* __restrict__ in, Rows rows, const W* __restrict__ w,
    uint4* __restrict__ out, int64_t pieces, int K, bool vec4) {
  static_assert(In::E == Out::E, "an input piece holds its output piece's elements");
  const int64_t t = blockIdx.x;
  const int64_t p = static_cast<int64_t>(blockIdx.y) * GR_THREADS + threadIdx.x;
  if (p >= pieces) return;
  float acc[Out::E];
#pragma unroll
  for (int j = 0; j < Out::E; ++j) acc[j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += KC) {
    typename Rows::Index idx[KC];
    float wk[KC];
    rows.template fetch<KC>(t, k0, K, vec4, w, idx, wk);
    typename In::Raw v[KC];
#pragma unroll
    for (int u = 0; u < KC; ++u)
      if (rows.live(idx[u])) v[u] = __ldg(in + static_cast<int64_t>(idx[u]) * pieces + p);
#pragma unroll
    for (int u = 0; u < KC; ++u) {
      if (!rows.live(idx[u])) continue;
      float f[In::E];
      In::load(v[u], f);
#pragma unroll
      for (int j = 0; j < Out::E; ++j) acc[j] += wk[u] * f[j];
    }
    // KC == 4 is launched only for K <= 4: one pass, and no reload of K
    // for a loop test between the last FMA and the store
    if (KC == 4) break;
  }
  out[t * pieces + p] = Out::store(acc);
}

// Launch the reduce of T tokens of H elements (H a multiple of Out::E, in and
// out 16-byte aligned); K == 0 writes zero rows.
template <class In, class Out, class Rows, class W>
int reduce_rows(const void* in, Rows rows, const W* w, void* out, int T, int64_t H, int K,
                bool vec4, cudaStream_t st) {
  const int64_t pieces = H / Out::E;
  if (T <= 0 || pieces <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(static_cast<unsigned>(T),
                  static_cast<unsigned>((pieces + GR_THREADS - 1) / GR_THREADS));
  const auto* r = static_cast<const typename In::Raw*>(in);
  uint4* o = static_cast<uint4*>(out);
  if (K <= 4)
    reduce_rows_kernel<In, Out, 4, Rows, W>
        <<<grid, GR_THREADS, 0, st>>>(r, rows, w, o, pieces, K, vec4);
  else
    reduce_rows_kernel<In, Out, 8, Rows, W>
        <<<grid, GR_THREADS, 0, st>>>(r, rows, w, o, pieces, K, false);
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
