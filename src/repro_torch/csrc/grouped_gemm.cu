// grouped_gemm: out[l] = x[l] @ w[l] for every local expert l, with f32
// accumulation; rows at or beyond counts[l] come out zero.
//
// Replaces src/repro/kernels/grouped_gemm.py:53 grouped_gemm (the Pallas
// kernel over an (expert, A/bm, F/bn, H/bk) grid with scalar-prefetched
// counts). At decode sizes (tens of valid rows per expert) it is bound by the
// bytes of the expert weights, which every live row tile streams once. Design:
//   * bf16: 64x128 output tile per block, 8 warps each owning a 32x32 piece
//     as 2x2 tensor-core fragments (WMMA, which lowers to mma.sync), and a
//     three-stage cp.async ring of 64x32 x and 32x128 w tiles in shared
//     memory so two tiles of weights are in flight while one is multiplied.
//   * f32: a plain shared-memory tiled product on the CUDA cores (64x64 tile,
//     4x4 outputs per thread), exact f32 as the reference requires.
// Each block reads counts[l] itself (no host sync) and, when its whole row
// tile lies beyond the count, writes zeros and skips the product; rows past
// the count are not even loaded (cp.async zero-fills them).
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int LDA = BK + 8;  // padded smem rows (elements) against bank conflicts
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;
constexpr int SMEM_BYTES = STAGES * (BM * LDA + BK * LDB) * 2;
static_assert(BM * LDC * 4 <= SMEM_BYTES, "epilogue tile must fit the ring");

__device__ inline void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // src-size 0: zero-fill, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ inline void zero_tile(__nv_bfloat16* o, int m0, int n0, int A, int F) {
  const float z[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < BM * BN / 8; i += blockDim.x) {
    const int r = m0 + i / (BN / 8), c = n0 + (i % (BN / 8)) * 8;
    if (r < A && c < F) store8(o, static_cast<int64_t>(r) * F + c, BF16, z);
  }
}

__global__ void __launch_bounds__(THREADS)
grouped_gemm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,
                         const int* __restrict__ counts,
                         __nv_bfloat16* __restrict__ out, int A, int H, int F) {
  const int l = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int cnt = min(counts[l], A);
  const __nv_bfloat16* xl = x + static_cast<int64_t>(l) * A * H;
  const __nv_bfloat16* wl = w + static_cast<int64_t>(l) * H * F;
  __nv_bfloat16* ol = out + static_cast<int64_t>(l) * A * F;
  if (m0 >= cnt) {
    zero_tile(ol, m0, n0, A, F);
    return;
  }

  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][BM][LDA]
  __nv_bfloat16* sB = sA + STAGES * BM * LDA;                   // [STAGES][BK][LDB]
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps over the 64x128 tile

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (H + BK - 1) / BK;
  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * BK;
    {  // x tile: BM x BK = 256 chunks of 8, one per thread
      const int r = tid / (BK / 8), c = (tid % (BK / 8)) * 8;
      const bool p = m0 + r < cnt && k0 + c < H;
      cp_async16(sA + (stage * BM + r) * LDA + c,
                 p ? xl + static_cast<int64_t>(m0 + r) * H + k0 + c : xl, p);
    }
    for (int i = tid; i < BK * BN / 8; i += THREADS) {  // w tile: two per thread
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const bool p = k0 + r < H && n0 + c < F;
      cp_async16(sB + (stage * BK + r) * LDB + c,
                 p ? wl + static_cast<int64_t>(k0 + r) * F + n0 + c : wl, p);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed
    __syncthreads();              // ...and every warp is done with tile kt-1
    const int nt = kt + STAGES - 1;
    if (nt < nk) load_tile(nt % STAGES, nt);
    cp_async_commit();
    const int st = kt % STAGES;
    const __nv_bfloat16* a = sA + st * BM * LDA;
    const __nv_bfloat16* b = sB + st * BK * LDB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], b + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  float* sC = reinterpret_cast<float*>(smem);  // [BM][LDC], reuses the ring
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sC + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN / 8; i += THREADS) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    if (m0 + r >= A || n0 + c >= F) continue;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = m0 + r < cnt ? sC[r * LDC + c + j] : 0.f;
    store8(ol, static_cast<int64_t>(m0 + r) * F + n0 + c, BF16, v);
  }
}

constexpr int FBM = 64, FBN = 64, FBK = 16;

__global__ void __launch_bounds__(256)
grouped_gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const int* __restrict__ counts, float* __restrict__ out,
                        int A, int H, int F) {
  const int l = blockIdx.z, m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  const int cnt = min(counts[l], A);
  const float* xl = x + static_cast<int64_t>(l) * A * H;
  const float* wl = w + static_cast<int64_t>(l) * H * F;
  float* ol = out + static_cast<int64_t>(l) * A * F;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  if (m0 >= cnt) {
    for (int i = tid; i < FBM * FBN; i += 256) {
      const int r = m0 + i / FBN, c = n0 + i % FBN;
      if (r < A && c < F) ol[static_cast<int64_t>(r) * F + c] = 0.f;
    }
    return;
  }
  __shared__ float As[FBK][FBM + 4];  // x tile, transposed
  __shared__ float Bs[FBK][FBN + 4];
  float acc[4][4] = {};
  for (int k0 = 0; k0 < H; k0 += FBK) {
    for (int i = tid; i < FBM * FBK; i += 256) {
      const int r = i / FBK, c = i % FBK;
      As[c][r] = (m0 + r < cnt && k0 + c < H)
          ? xl[static_cast<int64_t>(m0 + r) * H + k0 + c] : 0.f;
    }
    for (int i = tid; i < FBK * FBN; i += 256) {
      const int r = i / FBN, c = i % FBN;
      Bs[r][c] = (k0 + r < H && n0 + c < F)
          ? wl[static_cast<int64_t>(k0 + r) * F + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= A) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c < F) ol[static_cast<int64_t>(r) * F + c] = r < cnt ? acc[i][j] : 0.f;
    }
  }
}

}  // namespace

extern "C" int ep_grouped_gemm(const void* x, const void* w, const void* counts,
                               void* out, int L, int A, int H, int F, int dt,
                               void* stream) {
  if (L <= 0 || A <= 0 || F <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dt == BF16) {
    dim3 grid((F + BN - 1) / BN, (A + BM - 1) / BM, L);
    grouped_gemm_bf16_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<const int*>(counts), static_cast<__nv_bfloat16*>(out), A, H, F);
  } else if (dt == F32) {
    dim3 grid((F + FBN - 1) / FBN, (A + FBM - 1) / FBM, L);
    grouped_gemm_f32_kernel<<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const int*>(counts), static_cast<float*>(out), A, H, F);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
