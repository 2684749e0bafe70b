// recv_unpack: gather received rows through a slot map of any shape, with an
// optional fused fp8 dequantization (payload times its block scale in f32).
//
// Replaces src/repro/kernels/recv_unpack.py:43 recv_unpack (the Pallas copy
// and dequant kernels). Bound by bytes: each output row reads one received
// row (plus its scale row) and writes one row. What the design does about
// each cost of the first kernel (one block per output row, 2.2x its bound at
// DBRX's decode recv on an H100, slower than index_select):
//
// - Copy mode (the nccl_ep decode recv). Rows of a multiple of 8 elements on
//   16-byte aligned pointers run the row gather that dispatch_pack's copy
//   mode runs (gather.cuh gather_rows): a grid over (output row, chunk of
//   768 units) whose threads issue all their loads before their stores; a
//   sentinel slot (index outside [0, R)) stores zeros without a load; a
//   dtype change goes through f32 with round-to-nearest-even. Any other row
//   (a width not a multiple of 8, such as the f32 scale rows H/block wide
//   that hierarchical HT gathers) moves element by element, one block a row.
// - fp8 dequant (the HT dispatch recv). A grid over (output row, chunk of
//   128 threads x 48 payload bytes): each thread reads its row's slot index,
//   then issues its three 16-byte payload loads (16 fp8 values each) and
//   their three block scales before the first multiply. Pairs of fp8 values
//   go to f32 exactly through cvt.rn.f16x2.e4m3x2, each is multiplied by its
//   block's scale in f32 and rounded once to the output type, so the result
//   is bitwise the plain version's. A lane's 16 bf16 outputs are 32 bytes,
//   two 16-byte stores that would each leave every other 16 bytes of a
//   warp's span unwritten; lane pairs swap halves by shuffles so each store
//   instruction writes 512 contiguous bytes. A block width that is a multiple
//   of 8 but not 16, and an output of 4 or 1 bytes, take six 8-byte loads a
//   thread; other widths go element by element. A sentinel slot writes a
//   zero row without a load.
#include "gather.cuh"

namespace {

constexpr int ROW_THREADS = 128;
constexpr int DEQ_THREADS = 128;
constexpr int DEQ_BYTES = 48;     // payload bytes per thread, all loaded before any multiply

// Any row: one block per output row, element by element. Same-dtype rows
// move as raw bytes (exact); a dtype change converts through f32.
__global__ void __launch_bounds__(ROW_THREADS) copy_any_kernel(
    const void* __restrict__ recv, const int* __restrict__ gmap, void* __restrict__ out, int R,
    int64_t H, int rdt, int odt) {
  const int64_t r = blockIdx.x;
  const int src = gmap[r];
  const bool live = src >= 0 && src < R;
  const char* s = static_cast<const char*>(recv) +
                  static_cast<int64_t>(live ? src : 0) * H * dtype_size(rdt);
  char* d = static_cast<char*>(out) + r * H * dtype_size(odt);
  if (rdt == odt) {
    for (int64_t b = threadIdx.x; b < H * dtype_size(rdt); b += ROW_THREADS)
      d[b] = live ? s[b] : 0;
  } else {
    for (int64_t i = threadIdx.x; i < H; i += ROW_THREADS)
      store_elem(d, i, odt, live ? load_elem(s, i, rdt) : 0.f);
  }
}

// Four fp8 e4m3 values (one 32-bit word, the first in its low byte) to f32,
// exactly: e4m3 -> f16 loses nothing.
__device__ inline void fp8x4_to_float(uint32_t w, float* f) {
  const __half2 lo(__nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(w & 0xffffu),
                                              __NV_E4M3));
  const __half2 hi(__nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(w >> 16),
                                              __NV_E4M3));
  const float2 a = __half22float2(lo), b = __half22float2(hi);
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

// Eight payload bytes (8 fp8 values, within one quant block) a thread-step,
// U of them loaded before the first multiply. A lane's 8 outputs are one
// 16-byte store for a 2-byte type, so a warp's stores are contiguous.
__global__ void __launch_bounds__(DEQ_THREADS) dequant8_kernel(
    const uint2* __restrict__ recv, const float* __restrict__ scales,
    const int* __restrict__ gmap, void* __restrict__ out, int R, int64_t H, int blk, int odt) {
  constexpr int U = DEQ_BYTES / 8;
  const int64_t r = blockIdx.x;
  const int src = __ldg(gmap + r);
  const int64_t pieces = H / 8;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * DEQ_THREADS * U + threadIdx.x;
  char* orow = static_cast<char*>(out) + r * H * dtype_size(odt);
  const bool live = src >= 0 && src < R;
  const uint2* qrow = recv + static_cast<int64_t>(live ? src : 0) * pieces;
  const float* srow = scales + static_cast<int64_t>(live ? src : 0) * (H / blk);
  uint2 q[U];
  float s[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t i = base + u * DEQ_THREADS;
    q[u] = make_uint2(0u, 0u);
    s[u] = 0.f;
    if (live && i < pieces) {
      q[u] = __ldg(qrow + i);
      s[u] = __ldg(srow + i * 8 / blk);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t i = base + u * DEQ_THREADS;
    if (i >= pieces) continue;
    float v[8];
    fp8x4_to_float(q[u].x, v);
    fp8x4_to_float(q[u].y, v + 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = live ? v[j] * s[u] : 0.f;
    store8(orow, i * 8, odt, v);
  }
}

// Two f32 values rounded (to nearest even) to a pair of bf16 or f16.
__device__ inline uint32_t pack2(float a, float b, int odt) {
  if (odt == BF16) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  const __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Sixteen payload bytes a thread-step into a bf16 or f16 row. A warp owns
// 32 consecutive pieces (512 payload bytes, 1 KB of output); lanes 2m and
// 2m + 1 load pieces m and 16 + m, so each load instruction is one
// contiguous 512-byte read. Each lane's 16 outputs are 32 bytes; the lane
// pair swaps halves through one shuffle per word, so that the warp's first
// 16-byte store covers output bytes [0, 512) of its span and the second
// [512, 1024), each contiguous.
__global__ void __launch_bounds__(DEQ_THREADS) dequant16_kernel(
    const uint4* __restrict__ recv, const float* __restrict__ scales,
    const int* __restrict__ gmap, uint4* __restrict__ out, int R, int64_t H, int blk, int odt) {
  constexpr int U = DEQ_BYTES / 16;
  const int64_t r = blockIdx.x;
  const int src = __ldg(gmap + r);
  const int64_t pieces = H / 16;
  const int lane = threadIdx.x % 32;
  const bool odd = lane & 1;
  const int64_t span0 =
      static_cast<int64_t>(blockIdx.y) * DEQ_THREADS * U + threadIdx.x / 32 * 32;
  uint4* orow = out + r * (H / 8);
  const bool live = src >= 0 && src < R;
  const uint4* qrow = recv + static_cast<int64_t>(live ? src : 0) * pieces;
  const float* srow = scales + static_cast<int64_t>(live ? src : 0) * (H / blk);
  uint4 q[U];
  float s[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t i = span0 + u * DEQ_THREADS + lane / 2 + (odd ? 16 : 0);
    q[u] = make_uint4(0u, 0u, 0u, 0u);
    s[u] = 0.f;
    if (live && i < pieces) {
      q[u] = __ldg(qrow + i);
      s[u] = __ldg(srow + i * 16 / blk);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t span = span0 + u * DEQ_THREADS;
    uint32_t o[8];
    const uint32_t w[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float f[4];
      fp8x4_to_float(w[k], f);
      o[2 * k] = pack2(f[0] * s[u], f[1] * s[u], odt);
      o[2 * k + 1] = pack2(f[2] * s[u], f[3] * s[u], odt);
    }
    // even lanes send their second half, odd lanes their first
    uint32_t x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      x[k] = __shfl_xor_sync(0xffffffffu, odd ? o[k] : o[4 + k], 1);
    const uint4 mine_lo = make_uint4(o[0], o[1], o[2], o[3]);
    const uint4 mine_hi = make_uint4(o[4], o[5], o[6], o[7]);
    const uint4 theirs = make_uint4(x[0], x[1], x[2], x[3]);
    const uint4 lo = odd ? theirs : mine_lo;      // piece span + lane / 2, half lane % 2
    const uint4 hi = odd ? mine_hi : theirs;      // piece span + 16 + lane / 2, half lane % 2
    if (span + lane / 2 < pieces) orow[span * 2 + lane] = lo;
    if (span + 16 + lane / 2 < pieces) orow[span * 2 + 32 + lane] = hi;
  }
}

// Any block width: one block per output row, element by element.
__global__ void __launch_bounds__(ROW_THREADS) dequant_any_kernel(
    const __nv_fp8_storage_t* __restrict__ recv, const float* __restrict__ scales,
    const int* __restrict__ gmap, void* __restrict__ out, int R, int64_t H, int blk, int odt) {
  const int64_t r = blockIdx.x;
  const int src = gmap[r];
  const bool live = src >= 0 && src < R;
  const __nv_fp8_storage_t* qrow = recv + static_cast<int64_t>(live ? src : 0) * H;
  const float* srow = scales + static_cast<int64_t>(live ? src : 0) * (H / blk);
  void* orow = static_cast<char*>(out) + r * H * dtype_size(odt);
  for (int64_t h = threadIdx.x; h < H; h += ROW_THREADS)
    store_elem(orow, h, odt, live ? load_elem(qrow, h, FP8E4M3) * srow[h / blk] : 0.f);
}

}  // namespace

// gather != 0: the row gather (the wrapper's recv_unpack.copy_route decides).
extern "C" int ep_recv_unpack_copy(const void* recv, const void* gmap, void* out,
                                   int64_t rows, int R, int64_t H, int rdt,
                                   int odt, int gather, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* g = static_cast<const int*>(gmap);
  if (gather) return gather_rows(recv, g, out, rows, R, H, rdt, odt, st);
  if (rows > 0 && H > 0)
    copy_any_kernel<<<rows, ROW_THREADS, 0, st>>>(recv, g, out, R, H, rdt, odt);
  return static_cast<int>(cudaGetLastError());
}

// piece: payload bytes a thread-step, 16 (bf16 or f16 out), 8 or 1
// (recv_unpack.dequant_piece decides).
extern "C" int ep_recv_unpack_dequant(const void* recv, const void* scales,
                                      const void* gmap, void* out, int64_t rows,
                                      int R, int64_t H, int blk, int odt, int piece,
                                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scales);
  const int* g = static_cast<const int*>(gmap);
  if (rows > 0 && H > 0) {
    if (piece == 16) {           // bf16 or f16 out
      const dim3 grid(static_cast<unsigned>(rows),
                      static_cast<unsigned>((H / 16 + DEQ_THREADS * 3 - 1) / (DEQ_THREADS * 3)));
      dequant16_kernel<<<grid, DEQ_THREADS, 0, st>>>(static_cast<const uint4*>(recv), s, g,
                                                     static_cast<uint4*>(out), R, H, blk, odt);
    } else if (piece == 8) {
      const dim3 grid(static_cast<unsigned>(rows),
                      static_cast<unsigned>((H / 8 + DEQ_THREADS * 6 - 1) / (DEQ_THREADS * 6)));
      dequant8_kernel<<<grid, DEQ_THREADS, 0, st>>>(static_cast<const uint2*>(recv), s, g, out,
                                                    R, H, blk, odt);
    } else {
      dequant_any_kernel<<<rows, ROW_THREADS, 0, st>>>(
          static_cast<const __nv_fp8_storage_t*>(recv), s, g, out, R, H, blk, odt);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
