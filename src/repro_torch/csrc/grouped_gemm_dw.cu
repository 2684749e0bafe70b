// grouped_gemm_dw: the weight gradient of grouped_gemm,
// dW[l] = X[l, :n_l]ᵀ · dY[l, :n_l] with n_l = counts[l], f32 sums, written
// in the weights' dtype.
//
// The TPU kernel (src/repro/kernels/grouped_gemm.py:53) has no backward of
// its own: the reference differentiates the plain einsum by AD, whose
// weight cotangent is this product over the live rows (rows past the count
// carry no gradient: the forward zeroes them). Bound by the tensor cores at
// the training shapes (H x F = 6144 x 10752 per expert over thousands of
// rows).
//
// bf16: warp-level mma.sync through the WMMA API. A block of 256 threads
// owns a 128 x 128 tile of dW[l] (rows of H, columns of F) and walks the
// live rows of expert l in steps of 32: each step stages X[l, a0:a0+32,
// h-tile] and dY[l, a0:a0+32, f-tile] in shared memory (16-byte loads,
// zeros past the count or the edge; the next step's loads are in flight
// while this one multiplies), and the eight warps (2 x 4, 64 x 32 each)
// multiply them on m16n16k16 fragments: X's tile is read column-major, so
// the transpose costs nothing. The f32 accumulators go out through a
// per-warp 16 x 16 staging tile, rounded once. A tile of an expert with no
// live row is written as zeros.
// f32: a 16 x 16 shared-memory tile on the CUDA cores, exact f32 sums.
// Every element is summed by one thread in a fixed order: two calls give
// the same bits.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 128, BN = 128, BK = 32, THREADS = 256;
constexpr int LDA = BM + 8, LDB = BN + 8;  // padded rows stay 32-byte aligned

__global__ void __launch_bounds__(THREADS)
dw_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
               const int* __restrict__ counts, __nv_bfloat16* __restrict__ dw, int A, int H,
               int F) {
  __shared__ __align__(128) __nv_bfloat16 sx[BK][LDA];
  __shared__ __align__(128) __nv_bfloat16 sy[BK][LDB];
  __shared__ __align__(128) float stage[THREADS / 32][16 * 16];
  const int l = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n = min(max(counts[l], 0), A);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const __nv_bfloat16* xl = x + static_cast<int64_t>(l) * A * H;
  const __nv_bfloat16* yl = dy + static_cast<int64_t>(l) * A * F;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  // each thread moves two 16-byte pieces of each tile (32 rows x 16 pieces)
  uint4 rx[2], ry[2];
  const uint4 zero = make_uint4(0, 0, 0, 0);
  auto fetch = [&](int a0) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int idx = tid + p * THREADS, r = idx / 16, c = (idx % 16) * 8, a = a0 + r;
      rx[p] = a < n && m0 + c < H
                  ? *reinterpret_cast<const uint4*>(xl + static_cast<int64_t>(a) * H + m0 + c)
                  : zero;
      ry[p] = a < n && n0 + c < F
                  ? *reinterpret_cast<const uint4*>(yl + static_cast<int64_t>(a) * F + n0 + c)
                  : zero;
    }
  };
  if (n > 0) fetch(0);
  for (int a0 = 0; a0 < n; a0 += BK) {
    __syncthreads();  // the previous step is done with the tiles
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int idx = tid + p * THREADS, r = idx / 16, c = (idx % 16) * 8;
      *reinterpret_cast<uint4*>(&sx[r][c]) = rx[p];
      *reinterpret_cast<uint4*>(&sy[r][c]) = ry[p];
    }
    __syncthreads();
    if (a0 + BK < n) fetch(a0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(fa[i], &sx[kk][wm * 64 + i * 16], LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], &sy[kk][wn * 32 + j * 16], LDB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  float* sg = stage[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(sg, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r0 = m0 + wm * 64 + i * 16, c0 = n0 + wn * 32 + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int r = r0 + e / 16, c = c0 + e % 16;
        if (r < H && c < F)
          dw[(static_cast<int64_t>(l) * H + r) * F + c] = __float2bfloat16(sg[e]);
      }
      __syncwarp();
    }
}

constexpr int FT = 16;

__global__ void __launch_bounds__(FT * FT)
dw_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
              const int* __restrict__ counts, float* __restrict__ dw, int A, int H, int F) {
  __shared__ float sx[FT][FT + 1], sy[FT][FT + 1];
  const int l = blockIdx.z, ty = threadIdx.x / FT, tx = threadIdx.x % FT;
  const int m0 = blockIdx.y * FT, c = blockIdx.x * FT + tx;
  const int n = min(max(counts[l], 0), A);
  const float* xl = x + static_cast<int64_t>(l) * A * H;
  const float* yl = dy + static_cast<int64_t>(l) * A * F;
  float acc = 0.f;
  for (int a0 = 0; a0 < n; a0 += FT) {
    const int a = a0 + ty;
    sx[ty][tx] = a < n && m0 + tx < H ? xl[static_cast<int64_t>(a) * H + m0 + tx] : 0.f;
    sy[ty][tx] = a < n && c < F ? yl[static_cast<int64_t>(a) * F + c] : 0.f;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FT; ++k) acc = fmaf(sx[k][ty], sy[k][tx], acc);
    __syncthreads();
  }
  if (m0 + ty < H && c < F) dw[(static_cast<int64_t>(l) * H + m0 + ty) * F + c] = acc;
}

}  // namespace

// x: [L, A, H], dy: [L, A, F], counts: [L] int32, dw: [L, H, F], all of dtype
// dt (BF16 or F32); the wrapper guarantees H % 8 == F % 8 == 0 and 16-byte
// aligned operands.
extern "C" int ep_grouped_gemm_dw(const void* x, const void* dy, const void* counts, void* dw,
                                  int L, int A, int H, int F, int dt, void* stream) {
  if (L <= 0 || H <= 0 || F <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* cn = static_cast<const int*>(counts);
  if (dt == BF16) {
    dw_bf16_kernel<<<dim3((F + BN - 1) / BN, (H + BM - 1) / BM, L), THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy), cn,
        static_cast<__nv_bfloat16*>(dw), A, H, F);
  } else if (dt == F32) {
    dw_f32_kernel<<<dim3((F + FT - 1) / FT, (H + FT - 1) / FT, L), FT * FT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), cn,
        static_cast<float*>(dw), A, H, F);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
