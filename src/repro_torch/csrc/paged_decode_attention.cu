// paged_decode_attention: split-KV flash decoding over a paged KV pool, one
// query token per request, in two stages.
//
// Replaces src/repro/kernels/decode_attention.py:112 paged_decode_attention
// (the Pallas pair _stage1_kernel and _stage2_kernel: a (request, split,
// page) grid whose page axis runs in order over VMEM scratch, fed by a
// scalar-prefetched page table).
//
// Bound by bytes: every live K/V row is read once, and a decode query does
// two multiply-adds per element it reads. Here a block of stage 1 owns one
// (request, split, kv head, tile of at most 16 query heads): it reads its own
// page ids from the table, walks the split's live tokens in chunks of 16 (the
// TPU's sequential page axis becomes a loop), loads each chunk's K and V rows
// of its kv head with 16-byte loads into shared memory as f32, scores them
// with 8 threads per token, runs the online softmax with 8 threads per head
// and keeps the f32 accumulator in registers, each thread over its own value
// columns. Tokens at or past kv_len are never read: their rows are zero in
// shared memory and their probabilities an exact 0 (valid ? exp(s - m) : 0),
// so garbage in recycled or pad pages cannot change a bit of the result. An
// empty split writes o = 0 and lse = -1e30. Stage 2 reduces the splits of one
// (request, head) in a fixed order, giving an empty split exactly zero weight
// (lse > -1e30 / 2) and a request with no live token exactly 0. Every sum runs
// in a fixed order, so a request's result does not depend on its neighbours.
//
// Each chunk waits on its own loads, so the kernel leans on resident blocks
// to hide the memory's latency and runs at about 4x its byte bound at DBRX
// widths (PERF.md). A warp-level GQA kernel with q and the accumulator in
// registers and loads issued ahead, then wgmma, TMA and a split schedule
// sized to the card, are later work.
//
// In share_kv mode (absorbed MLA: Hkv == 1, values are the leading dv key
// columns) each head tile reads the shared pool once, so the pool is read
// once per tile of 16 heads.
#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int TC = 16;        // tokens per chunk
constexpr int DPARTS = 8;     // threads per token (scores) and per head (softmax)
constexpr int MAXQ = 16;      // query heads per block
constexpr int KPAD = 8;       // floats of row padding: conflict-free score reads
static_assert(TC * DPARTS == THREADS, "one score thread group per token");
static_assert(MAXQ * DPARTS == THREADS && TC == 2 * DPARTS, "softmax layout");
static_assert(TC % 4 == 0, "p is read four tokens at a time");

__host__ __device__ inline int64_t stage1_smem_floats(int qt, int dk, int dv, int share_kv) {
  return static_cast<int64_t>(qt) * dk + TC * (dk + KPAD) +
         (share_kv ? 0 : TC * dv) + qt * TC + 3 * qt;
}

__device__ inline void put8(float* dst, const float v[8]) {
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(v[0], v[1], v[2], v[3]);
  d[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Rows [0, TC) of one chunk into smem (row stride `stride` floats): token
// c0 + t for t < n through the page table, zeros for t >= n. Positions fit
// in 32 bits (max_pages * page < 2^31); pool offsets are 64-bit.
__device__ inline void load_chunk(const void* pool, int dt, const int* tbl_row,
                                  int c0, int n, int page, int Hkv, int kvh,
                                  int width, float* dst, int stride) {
  const int vecs = width / 8;
  const int64_t row_bytes = static_cast<int64_t>(width) * dtype_size(dt);
  for (int i = threadIdx.x; i < TC * vecs; i += THREADS) {
    const int t = i / vecs, c = (i - t * vecs) * 8;
    float v[8];
    if (t < n) {
      const int pos = c0 + t;
      const int j = pos / page;
      const int64_t row = (static_cast<int64_t>(tbl_row[j]) * page + (pos - j * page)) * Hkv + kvh;
      load8(static_cast<const char*>(pool) + row * row_bytes, c, dt, v);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = 0.f;
    }
    put8(dst + t * stride + c, v);
  }
}

// MQ query heads and MC value columns per thread at most (registers scale
// with MQ * MC): <8, 1> serves GQA up to 8 heads per kv head and dv <= 128,
// held to 64 registers so that 8 blocks fit an SM (the chunk loop waits on
// its loads, so resident blocks are what hides the memory's latency); <16,
// 4> serves the rest (absorbed MLA: 16-head tiles, dv <= 512).
template <int MQ, int MC>
__global__ void __launch_bounds__(THREADS, MQ <= 8 ? 8 : 1) paged_stage1_kernel(
    const void* __restrict__ q, const void* __restrict__ kp, const void* __restrict__ vp,
    const int* __restrict__ tbl, const int* __restrict__ lens, float* __restrict__ o,
    float* __restrict__ lse, int Hq, int Hkv, int dk, int dv, int page, int max_pages,
    int qt, int ntiles, float scale, int qdt, int kdt, int share_kv) {
  extern __shared__ __align__(16) float sm[];
  const int kvh = blockIdx.x / ntiles, tile = blockIdx.x % ntiles;
  const int s = blockIdx.y, S = gridDim.y;
  const int64_t b = blockIdx.z;
  const int G = Hq / Hkv;
  const int h0 = kvh * G + tile * qt;
  const int nq = min(qt, G - tile * qt);
  const int ks_stride = dk + KPAD;
  float* qs = sm;                                   // [qt][dk]
  float* ks = qs + qt * dk;                         // [TC][dk + KPAD]
  float* vs = ks + TC * ks_stride;                  // [TC][dv] (not in share_kv)
  float* ps = vs + (share_kv ? 0 : TC * dv);        // [qt][TC] scores, then p
  float* ms = ps + qt * TC;                         // [qt] running max
  float* ls = ms + qt;                              // [qt] running sum
  float* cs = ls + qt;                              // [qt] this chunk's correction
  const int tid = threadIdx.x;

  const int64_t qsz = dtype_size(qdt);
  for (int i = tid; i < nq * (dk / 8); i += THREADS) {
    const int qh = i / (dk / 8), c = (i % (dk / 8)) * 8;
    float v[8];
    load8(static_cast<const char*>(q) + ((b * Hq + h0 + qh) * dk) * qsz, c, qdt, v);
    put8(qs + qh * dk + c, v);
  }
  if (tid < nq) {
    ms[tid] = NEG_INF;
    ls[tid] = 0.f;
  }
  float acc[MC][MQ];
#pragma unroll
  for (int j = 0; j < MC; ++j)
#pragma unroll
    for (int h = 0; h < MQ; ++h) acc[j][h] = 0.f;

  const int* tbl_row = tbl + b * max_pages;
  const int span = (max_pages / S) * page;
  const int start = s * span;
  const int end = min(start + span, lens[b]);
  const int t = tid / DPARTS, dp = tid % DPARTS;   // score phase: token, column part
  const int sh = tid / DPARTS, sj = tid % DPARTS;  // softmax phase: head, token part
  const float* vrows = share_kv ? ks : vs;
  const int vstride = share_kv ? ks_stride : dv;

  for (int c0 = start; c0 < end; c0 += TC) {
    const int n = min(TC, end - c0);
    __syncthreads();                                // the last chunk's readers are done
    load_chunk(kp, kdt, tbl_row, c0, n, page, Hkv, kvh, dk, ks, ks_stride);
    if (!share_kv) load_chunk(vp, kdt, tbl_row, c0, n, page, Hkv, kvh, dv, vs, dv);
    __syncthreads();

    // scores: 8 threads per token, each over every 8th group of 4 columns
    // (16-byte shared-memory reads), then a fixed butterfly over the 8 lanes
    // (nq is the same in the whole block)
    float part[MQ];
#pragma unroll
    for (int h = 0; h < MQ; ++h) part[h] = 0.f;
    for (int d = 4 * dp; d < dk; d += 4 * DPARTS) {
      const float4 kv = *reinterpret_cast<const float4*>(ks + t * ks_stride + d);
#pragma unroll
      for (int h = 0; h < MQ; ++h) {
        if (h < nq) {
          const float4 qv = *reinterpret_cast<const float4*>(qs + h * dk + d);
          part[h] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
        }
      }
    }
#pragma unroll
    for (int h = 0; h < MQ; ++h) {
      if (h < nq) {
#pragma unroll
        for (int off = DPARTS / 2; off > 0; off /= 2)
          part[h] += __shfl_xor_sync(0xffffffffu, part[h], off);
      }
    }
    if (dp == 0) {
#pragma unroll
      for (int h = 0; h < MQ; ++h)
        if (h < nq) ps[h * TC + t] = t < n ? part[h] * scale : NEG_INF;
    }
    __syncthreads();

    // online softmax: 8 threads per head, two tokens each, fixed butterflies;
    // masked positions are an exact 0. Every lane joins the shuffles.
    {
      const bool act = sh < nq;
      const float s0 = act ? ps[sh * TC + sj] : NEG_INF;
      const float s1 = act ? ps[sh * TC + sj + DPARTS] : NEG_INF;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = DPARTS / 2; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = act ? ms[sh] : NEG_INF;
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = sj < n ? expf(s0 - m_new) : 0.f;
      const float p1 = sj + DPARTS < n ? expf(s1 - m_new) : 0.f;
      float psum = p0 + p1;
#pragma unroll
      for (int off = DPARTS / 2; off > 0; off /= 2)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      if (act) {
        ps[sh * TC + sj] = p0;
        ps[sh * TC + sj + DPARTS] = p1;
        if (sj == 0) {
          const float corr = expf(m_prev - m_new);
          ls[sh] = ls[sh] * corr + psum;
          ms[sh] = m_new;
          cs[sh] = corr;
        }
      }
    }
    __syncthreads();

    // acc = acc * corr + sum_t p[t] * v[t], each thread over its own columns,
    // the heads side by side, four tokens per 16-byte read of p; rows past n
    // are zero in shared memory and their p an exact 0
#pragma unroll
    for (int j = 0; j < MC; ++j) {
      const int col = tid + j * THREADS;
      if (col < dv) {
        float ctx[MQ];
#pragma unroll
        for (int h = 0; h < MQ; ++h) ctx[h] = 0.f;
#pragma unroll
        for (int u = 0; u < TC; u += 4) {
          const float v0 = vrows[u * vstride + col], v1 = vrows[(u + 1) * vstride + col];
          const float v2 = vrows[(u + 2) * vstride + col], v3 = vrows[(u + 3) * vstride + col];
#pragma unroll
          for (int h = 0; h < MQ; ++h) {
            if (h < nq) {
              const float4 pv = *reinterpret_cast<const float4*>(ps + h * TC + u);
              ctx[h] += pv.x * v0 + pv.y * v1 + pv.z * v2 + pv.w * v3;
            }
          }
        }
#pragma unroll
        for (int h = 0; h < MQ; ++h)
          if (h < nq) acc[j][h] = acc[j][h] * cs[h] + ctx[h];
      }
    }
  }
  __syncthreads();

  const int64_t orow = (b * S + s) * Hq + h0;
#pragma unroll
  for (int j = 0; j < MC; ++j) {
    const int col = tid + j * THREADS;
#pragma unroll
    for (int h = 0; h < MQ; ++h) {
      if (h < nq && col < dv) {
        const float l = ls[h];
        o[(orow + h) * dv + col] = l > 0.f ? acc[j][h] / l : 0.f;
      }
    }
  }
  if (tid < nq) {
    const float l = ls[tid];
    lse[orow + tid] = l > 0.f ? ms[tid] + logf(l) : NEG_INF;
  }
}

__global__ void __launch_bounds__(THREADS) paged_stage2_kernel(
    const float* __restrict__ o, const float* __restrict__ lse, float* __restrict__ out,
    int S, int Hq, int dv) {
  const int h = blockIdx.x;
  const int64_t b = blockIdx.y;
  const float* lrow = lse + b * S * Hq + h;         // stride Hq over the splits
  float mx = lrow[0];
  for (int s = 1; s < S; ++s) mx = fmaxf(mx, lrow[static_cast<int64_t>(s) * Hq]);
  for (int col = threadIdx.x; col < dv; col += THREADS) {
    float denom = 0.f, acc = 0.f;
    for (int s = 0; s < S; ++s) {
      const float l = lrow[static_cast<int64_t>(s) * Hq];
      const float w = l > NEG_INF / 2 ? expf(l - mx) : 0.f;
      denom += w;
      acc += w * o[((b * S + s) * Hq + h) * dv + col];
    }
    out[(b * Hq + h) * dv + col] = denom > 0.f ? acc / denom : 0.f;
  }
}

}  // namespace

template <int MQ, int MC>
int launch_stage1(const void* q, const void* kp, const void* vp, const void* tbl,
                  const void* lens, void* o, void* lse, int B, int S, int Hq, int Hkv,
                  int dk, int dv, int page, int max_pages, int qt, int ntiles, float scale,
                  int qdt, int kdt, int share_kv, int64_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(paged_stage1_kernel<MQ, MC>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(Hkv * ntiles, S, B);
  paged_stage1_kernel<MQ, MC><<<grid, THREADS, smem, stream>>>(
      q, kp, vp, static_cast<const int*>(tbl), static_cast<const int*>(lens),
      static_cast<float*>(o), static_cast<float*>(lse), Hq, Hkv, dk, dv, page, max_pages,
      qt, ntiles, scale, qdt, kdt, share_kv);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ep_paged_decode_stage1(const void* q, const void* kp, const void* vp,
                                      const void* tbl, const void* lens, void* o, void* lse,
                                      int B, int S, int Hq, int Hkv, int dk, int dv,
                                      int page, int max_pages, float scale, int qdt,
                                      int kdt, int share_kv, void* stream) {
  const int G = Hq / Hkv;
  const int qt = G < MAXQ ? G : MAXQ;
  const int ntiles = (G + qt - 1) / qt;
  const int64_t smem = stage1_smem_floats(qt, dk, dv, share_kv) * 4;
  if (smem > 232448 || dv > 4 * THREADS) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qt <= 8 && dv <= THREADS)
    return launch_stage1<8, 1>(q, kp, vp, tbl, lens, o, lse, B, S, Hq, Hkv, dk, dv, page,
                               max_pages, qt, ntiles, scale, qdt, kdt, share_kv, smem, st);
  return launch_stage1<16, 4>(q, kp, vp, tbl, lens, o, lse, B, S, Hq, Hkv, dk, dv, page,
                              max_pages, qt, ntiles, scale, qdt, kdt, share_kv, smem, st);
}

extern "C" int ep_paged_decode_stage2(const void* o, const void* lse, void* out, int B,
                                      int S, int Hq, int dv, void* stream) {
  if (B > 0) {
    dim3 grid(Hq, B);
    paged_stage2_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(o), static_cast<const float*>(lse),
        static_cast<float*>(out), S, Hq, dv);
  }
  return static_cast<int>(cudaGetLastError());
}
