// flash_attention's backward: dQ, dK and dV of causal (optionally
// sliding-window) GQA attention from the forward's output O and its row
// log-sum-exp, without the [Sq, Sk] probabilities in memory.
//
// The TPU kernel (src/repro/kernels/flash_attention.py:86) has no backward
// of its own: the reference differentiates the plain form by AD. With
// z = scale * q·k, p = exp(z - lse) on live pairs (0 elsewhere) and
// delta = rowsum(dO * O):
//   dV[k] = sum_q p[q,k] dO[q]
//   dS[q,k] = p[q,k] (dO[q]·V[k] - delta[q])
//   dK[k] = scale * sum_q dS[q,k] Q[q]      (summed over the G query heads)
//   dQ[q] = scale * sum_k dS[q,k] K[k]
// Two kernels, both on the CUDA cores in f32 (bf16 or f32 inputs, outputs
// in the inputs' type), tiles of 64 queries by 64 keys in shared memory:
//   * ep_flash_bwd_dq: one block per 64 query rows of one (batch, query
//     head). It first computes delta for its rows (O and dO once each) and
//     writes it, then walks the KV tiles its rows reach, recomputes p and
//     dS, and accumulates dQ in registers.
//   * ep_flash_bwd_dkdv: one block per 64 keys of one (batch, kv head). It
//     walks the G query heads of its kv head and, for each, the query tiles
//     that reach its keys, so GQA's sum stays inside the block: dK and dV
//     accumulate in registers and are written once. It reads the delta the
//     first kernel wrote, so the entry launches dQ first.
// No atomics: every output element is summed by one thread in a fixed
// order, so two calls give the same bits. Tiles that no (query, key) pair
// of the mask reaches are skipped, as in the forward; the tiles that are
// walked test each pair (causal, window, past Sq or Sk).
//
// Thread layout (256 threads): thread (ty, tx) = (t / 16, t % 16) owns rows
// ty + 16 i (i < 4) and columns tx + 16 j of a 64-wide product, so a warp
// reads two rows (broadcast) and sixteen consecutive columns (distinct
// banks) of the padded shared tiles.
#include "common.cuh"

namespace {

constexpr int TQ = 64, TK = 64, THREADS = 256;

struct Geo {
  int B, Hq, Hkv, G, Sq, Sk;
  float scale;
  int window;  // <= 0: none
  bool causal;
};

__device__ __forceinline__ bool live(int r, int c, const Geo& g) {
  return r < g.Sq && c < g.Sk && (!g.causal || c <= r) &&
         (g.window <= 0 || r - c < g.window);
}

// Whether any pair of rows [q0, q0 + TQ) and keys [k0, k0 + TK) is live.
__device__ __forceinline__ bool tiles_meet(int q0, int k0, const Geo& g) {
  const int q_last = min(q0 + TQ, g.Sq) - 1, k_last = min(k0 + TK, g.Sk) - 1;
  if (q0 > q_last || k0 > k_last) return false;
  if (g.causal && k0 > q_last) return false;
  if (g.window > 0 && q0 - k_last >= g.window) return false;
  return true;
}

__device__ __forceinline__ float ld(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}

// rows [r0, r0 + 64) of head h of a [B, S, H, D] tensor into a padded f32
// tile (zeros past S)
template <typename T, int D>
__device__ __forceinline__ void load_tile(float (*dst)[D + 1], const T* src, int b, int h,
                                          int H, int S, int r0) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, c = i % D, row = r0 + r;
    dst[r][c] = row < S ? ld(src, ((static_cast<int64_t>(b) * S + row) * H + h) * D + c) : 0.f;
  }
}

// s[i][j] = A[ty + 16 i]·B[tx + 16 j] and e[i][j] = C[ty + 16 i]·E[tx + 16 j]
// over D columns: two 64 x 64 products that share one walk.
template <int D>
__device__ __forceinline__ void two_products(float (*A)[D + 1], float (*Bm)[D + 1],
                                             float (*C)[D + 1], float (*E)[D + 1],
                                             float s[4][4], float e[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = e[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], c[4], bb[4], ee[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A[ty + 16 * i][d];
      c[i] = C[ty + 16 * i][d];
      bb[i] = Bm[tx + 16 * i][d];
      ee[i] = E[tx + 16 * i][d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], bb[j], s[i][j]);
        e[i][j] = fmaf(c[i], ee[j], e[i][j]);
      }
  }
}

// p and dS of one (query tile, key tile) from the scores s and dO·V (in e):
// p = exp(scale s - lse) on live pairs, dS = p (e - delta).
template <int D>
__device__ __forceinline__ void probs(float s[4][4], float e[4][4], const float* sl,
                                      const float* sd, int q0, int k0, const Geo& g) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float p = live(q0 + r, k0 + c, g) ? expf(s[i][j] * g.scale - sl[r]) : 0.f;
      s[i][j] = p;
      e[i][j] = p * (e[i][j] - sd[r]);
    }
  }
}

template <typename T, int D>
struct DqSmem {
  float q[TQ][D + 1], dout[TQ][D + 1], k[TK][D + 1], v[TK][D + 1];
  float ds[TQ][TK + 1];
  float lse[TQ], delta[TQ];
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    T* __restrict__ dq, const Geo g) {
  extern __shared__ float4 smem_raw[];
  DqSmem<T, D>& sm = *reinterpret_cast<DqSmem<T, D>*>(smem_raw);
  const int bh = blockIdx.x, b = bh / g.Hq, h = bh % g.Hq, kvh = h / g.G;
  const int q0 = blockIdx.y * TQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  load_tile<T, D>(sm.q, q, b, h, g.Hq, g.Sq, q0);
  load_tile<T, D>(sm.dout, dout, b, h, g.Hq, g.Sq, q0);
  {  // delta = rowsum(dO * O): four threads a row, a quarter of D each
    const int r = tid / 4, part = tid % 4, row = q0 + r;
    float acc = 0.f;
    if (row < g.Sq) {
      const int64_t base = ((static_cast<int64_t>(b) * g.Sq + row) * g.Hq + h) * D;
      for (int c = part * (D / 4); c < (part + 1) * (D / 4); ++c)
        acc = fmaf(ld(dout, base + c), ld(o, base + c), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      sm.delta[r] = acc;
      sm.lse[r] = row < g.Sq ? lse[static_cast<int64_t>(bh) * g.Sq + row] : 0.f;
      if (row < g.Sq) delta[static_cast<int64_t>(bh) * g.Sq + row] = acc;
    }
  }
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  const int nk = (g.Sk + TK - 1) / TK;
  for (int jt = 0; jt < nk; ++jt) {
    const int k0 = jt * TK;
    if (!tiles_meet(q0, k0, g)) continue;
    __syncthreads();  // the previous tile is done with k, v, ds
    load_tile<T, D>(sm.k, k, b, kvh, g.Hkv, g.Sk, k0);
    load_tile<T, D>(sm.v, v, b, kvh, g.Hkv, g.Sk, k0);
    __syncthreads();
    float s[4][4], e[4][4];
    two_products<D>(sm.q, sm.k, sm.dout, sm.v, s, e);
    probs<D>(s, e, sm.lse, sm.delta, q0, k0, g);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sm.ds[ty + 16 * i][tx + 16 * j] = e[i][j];
    __syncthreads();
    for (int c = 0; c < TK; ++c) {
      float a[4], kk[D / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.ds[ty + 16 * i][c];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) kk[j] = sm.k[c][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(a[i], kk[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= g.Sq) continue;
    const int64_t base = ((static_cast<int64_t>(b) * g.Sq + row) * g.Hq + h) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) st(dq, base + tx + 16 * j, acc[i][j] * g.scale);
  }
}

template <typename T, int D>
struct DkvSmem {
  float k[TK][D + 1], v[TK][D + 1], q[TQ][D + 1], dout[TQ][D + 1];
  float p[TQ][TK + 1], ds[TQ][TK + 1];
  float lse[TQ], delta[TQ];
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, const Geo g) {
  extern __shared__ float4 smem_raw[];
  DkvSmem<T, D>& sm = *reinterpret_cast<DkvSmem<T, D>*>(smem_raw);
  const int bk = blockIdx.x, b = bk / g.Hkv, kvh = bk % g.Hkv;
  const int k0 = blockIdx.y * TK;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  load_tile<T, D>(sm.k, k, b, kvh, g.Hkv, g.Sk, k0);
  load_tile<T, D>(sm.v, v, b, kvh, g.Hkv, g.Sk, k0);
  float adk[4][D / 16], adv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) adk[i][j] = adv[i][j] = 0.f;
  const int nq = (g.Sq + TQ - 1) / TQ;
  for (int gi = 0; gi < g.G; ++gi) {
    const int h = kvh * g.G + gi;
    const int64_t lrow = static_cast<int64_t>(b * g.Hq + h) * g.Sq;
    for (int it = 0; it < nq; ++it) {
      const int q0 = it * TQ;
      if (!tiles_meet(q0, k0, g)) continue;
      __syncthreads();  // the previous tile is done with q, dout, p, ds
      load_tile<T, D>(sm.q, q, b, h, g.Hq, g.Sq, q0);
      load_tile<T, D>(sm.dout, dout, b, h, g.Hq, g.Sq, q0);
      if (tid < TQ) {
        const int row = q0 + tid;
        sm.lse[tid] = row < g.Sq ? lse[lrow + row] : 0.f;
        sm.delta[tid] = row < g.Sq ? delta[lrow + row] : 0.f;
      }
      __syncthreads();
      float s[4][4], e[4][4];
      two_products<D>(sm.q, sm.k, sm.dout, sm.v, s, e);
      probs<D>(s, e, sm.lse, sm.delta, q0, k0, g);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sm.p[ty + 16 * i][tx + 16 * j] = s[i][j];
          sm.ds[ty + 16 * i][tx + 16 * j] = e[i][j];
        }
      __syncthreads();
      // this thread's keys ty + 16 i, columns tx + 16 j
      for (int r = 0; r < TQ; ++r) {
        float pp[4], dd[4], qq[D / 16], oo[D / 16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pp[i] = sm.p[r][ty + 16 * i];
          dd[i] = sm.ds[r][ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          qq[j] = sm.q[r][tx + 16 * j];
          oo[j] = sm.dout[r][tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < D / 16; ++j) {
            adv[i][j] = fmaf(pp[i], oo[j], adv[i][j]);
            adk[i][j] = fmaf(dd[i], qq[j], adk[i][j]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= g.Sk) continue;
    const int64_t base = ((static_cast<int64_t>(b) * g.Sk + key) * g.Hkv + kvh) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      st(dk, base + tx + 16 * j, adk[i][j] * g.scale);
      st(dv, base + tx + 16 * j, adv[i][j]);
    }
  }
}

constexpr int MAX_DEVICES = 64;

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const void* lse, void* delta, void* dq, void* dk,
                   void* dv, const Geo& g, cudaStream_t st) {
  static bool sized[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  constexpr int DQ_SMEM = sizeof(DqSmem<T, D>), DKV_SMEM = sizeof(DkvSmem<T, D>);
  if (!sized[dev]) {
    e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, DKV_SMEM);
    if (e != cudaSuccess) return e;
    sized[dev] = true;
  }
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const float* tl = static_cast<const float*>(lse);
  float* td = static_cast<float*>(delta);
  flash_bwd_dq_kernel<T, D><<<dim3(g.B * g.Hq, (g.Sq + TQ - 1) / TQ), THREADS, DQ_SMEM, st>>>(
      tq, tk, tv, static_cast<const T*>(o), tdo, tl, td, static_cast<T*>(dq), g);
  e = cudaGetLastError();
  if (e != cudaSuccess || g.Sk == 0) return e;
  flash_bwd_dkdv_kernel<T, D><<<dim3(g.B * g.Hkv, (g.Sk + TK - 1) / TK), THREADS, DKV_SMEM,
                                 st>>>(tq, tk, tv, tdo, tl, td, static_cast<T*>(dk),
                                       static_cast<T*>(dv), g);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: [B, Sq, Hq, D]; k, v, dk, dv: [B, Sk, Hkv, D], contiguous,
// all of dtype dt (BF16 or F32); lse (read) and delta (written): [B, Hq, Sq]
// f32. Launches the dQ kernel, then the dK/dV kernel.
extern "C" int ep_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* o, const void* dout, const void* lse,
                                      void* delta, void* dq, void* dk, void* dv, int B,
                                      int Hq, int Hkv, int Sq, int Sk, int D, float scale,
                                      int window, int causal, int dt, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return static_cast<int>(cudaGetLastError());
  if (Hkv <= 0 || Hq % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  const Geo g{B, Hq, Hkv, Hq / Hkv, Sq, Sk, scale, window, causal != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dt == BF16 && D == 128)
    e = launch<__nv_bfloat16, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, g, s);
  else if (dt == BF16 && D == 64)
    e = launch<__nv_bfloat16, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, g, s);
  else if (dt == F32 && D == 128)
    e = launch<float, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, g, s);
  else if (dt == F32 && D == 64)
    e = launch<float, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, g, s);
  return static_cast<int>(e);
}
