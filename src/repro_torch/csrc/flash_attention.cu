// flash_attention: causal (optionally sliding-window) GQA attention with an
// online softmax, for prefill and training forwards without a KV cache.
//
// Replaces src/repro/kernels/flash_attention.py:86 flash_attention (the
// Pallas kernel over a (B, Hq, Sq/bq, Sk/bk) grid whose innermost KV axis
// carries m, l and the accumulator in VMEM scratch). At prefill lengths it
// is bound by the tensor cores: 4·d operations per live (query, key) pair
// against one read of Q, K, V and one write of O. Design:
//   * bf16: one block of 4 warps per (batch, query head, 64-row query tile);
//     each warp owns 16 query rows. Q stays in registers as mma.sync A
//     fragments for the whole walk. K/V tiles of 64 keys stream through a
//     two-stage cp.async ring in shared memory; S = Q·Kᵀ and O += P·V run on
//     mma.sync m16n8k16 (bf16 in, f32 accumulate), P taken from the S
//     accumulators in registers (rounded to bf16 for the product) and V
//     read transposed with ldmatrix. m, l and O stay in f32 registers.
//   * f32: a plain shared-memory kernel on the CUDA cores, exact f32.
// GQA reads kv head h / G; nothing is repeated in memory. Masked scores are
// the finite -1e30 of the reference, so a row with no live key yet in a tile
// gets p = 1 on garbage that the first live key wipes exactly (corr = 0),
// where -inf would give NaN. Only the KV tiles a query tile can reach are
// walked (the causal and window skips). The query-tile grid axis runs
// heaviest first, so the long causal tiles start before the short ones.
// Every tensor is read through its (batch, head, seq) strides, with the
// head dimension contiguous; the wrapper passes the model's [B, S, H, d].
#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64, BKV = 64, THREADS = 128;

struct Geometry {
  int Sq, Sk, G, Hq;
  int64_t qsb, qsh, qss;  // strides of q (and o) in elements: batch, head, seq
  int64_t ksb, ksh, kss;  // strides of k and v
  float scale;
  int window;             // <= 0: none
  bool causal;
};

__device__ inline bool live(int r, int c, const Geometry& g) {
  return c < g.Sk && (!g.causal || c <= r) && (g.window <= 0 || r - c < g.window);
}

// The KV tiles (of `bkv` keys) that rows [q0, q_last] can reach.
__device__ inline void tile_range(int q0, int q_last, int bkv, const Geometry& g,
                                  int* lo, int* hi) {
  const int nk = (g.Sk + bkv - 1) / bkv;
  *hi = g.causal ? min(nk - 1, q_last / bkv) : nk - 1;
  *lo = 0;
  if (g.window > 0) {  // tile j is live iff q0 - (j*bkv + bkv - 1) < window
    const int first = q0 - g.window - bkv + 2;
    if (first > 0) *lo = (first + bkv - 1) / bkv;
  }
}

__device__ inline uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ inline void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline void ldmatrix_x4_trans(uint32_t r[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ inline void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // src-size 0: zero-fill, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int D>
constexpr int bf16_smem_bytes() {
  return 2 * 2 * BKV * (D + 8) * 2;  // two stages of K and V, rows padded by 8
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                  Geometry geo) {
  constexpr int LD = D + 8;  // padded smem row: 8 rows of a fragment hit 8 bank groups
  constexpr int NT = BKV / 8, DT = D / 8, KS = D / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][BKV][LD]
  __nv_bfloat16* sV = sK + 2 * BKV * LD;                         // [2][BKV][LD]

  const int bh = blockIdx.x, b = bh / geo.Hq, h = bh % geo.Hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const __nv_bfloat16* qp = q + b * geo.qsb + h * geo.qsh;
  const __nv_bfloat16* kp = k + b * geo.ksb + (h / geo.G) * geo.ksh;
  const __nv_bfloat16* vp = v + b * geo.ksb + (h / geo.G) * geo.ksh;

  uint32_t qa[KS][4];  // this warp's 16 rows of Q as A fragments
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int c = s * 16 + 2 * t;
    qa[s][0] = r0 < geo.Sq ? ld32(qp + r0 * geo.qss + c) : 0u;
    qa[s][1] = r1 < geo.Sq ? ld32(qp + r1 * geo.qss + c) : 0u;
    qa[s][2] = r0 < geo.Sq ? ld32(qp + r0 * geo.qss + c + 8) : 0u;
    qa[s][3] = r1 < geo.Sq ? ld32(qp + r1 * geo.qss + c + 8) : 0u;
  }

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // l: this thread's part

  int jlo, jhi;
  tile_range(q0, min(q0 + BQ, geo.Sq) - 1, BKV, geo, &jlo, &jhi);

  auto load_tile = [&](int stage, int j) {
    const int k0 = j * BKV;
    for (int i = tid; i < BKV * D / 8; i += THREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool p = k0 + r < geo.Sk;
      const int64_t off = static_cast<int64_t>(k0 + r) * geo.kss + c;
      cp_async16(sK + (stage * BKV + r) * LD + c, p ? kp + off : kp, p);
      cp_async16(sV + (stage * BKV + r) * LD + c, p ? vp + off : vp, p);
    }
    cp_async_commit();
  };

  if (jlo <= jhi) load_tile(0, jlo);
  for (int j = jlo; j <= jhi; ++j) {
    const int st = (j - jlo) & 1;
    if (j < jhi) {
      load_tile(st ^ 1, j + 1);
      cp_async_wait<1>();  // tile j has landed, j+1 may still be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* K = sK + st * BKV * LD;
    const __nv_bfloat16* V = sV + st * BKV * LD;

    // ---- S = Q·Kᵀ for this warp's 16 rows and the tile's 64 keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kr = K + (n * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) mma_bf16(s[n], qa[ks], ld32(kr + ks * 16), ld32(kr + ks * 16 + 8));
    }

    // ---- mask, online softmax (rows r0 and r1; a quad of lanes shares a row)
    const int k0 = j * BKV;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = k0 + n * 8 + 2 * t;
      s[n][0] = live(r0, c, geo) ? s[n][0] * geo.scale : NEG_INF;
      s[n][1] = live(r0, c + 1, geo) ? s[n][1] * geo.scale : NEG_INF;
      s[n][2] = live(r1, c, geo) ? s[n][2] * geo.scale : NEG_INF;
      s[n][3] = live(r1, c + 1, geo) ? s[n][3] * geo.scale : NEG_INF;
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = expf(s[n][0] - mn0);
      s[n][1] = expf(s[n][1] - mn0);
      s[n][2] = expf(s[n][2] - mn1);
      s[n][3] = expf(s[n][3] - mn1);
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }

    // ---- O += P·V: the S accumulators of key steps 2kk, 2kk+1 are the A
    // fragment of key step kk; V comes in transposed through ldmatrix
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int mat = lane / 8, row = kk * 16 + (mat & 1) * 8 + lane % 8;
#pragma unroll
      for (int n = 0; n < DT; n += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, V + row * LD + (n + (mat >> 1)) * 8);
        mma_bf16(acc[n], pa, vb[0], vb[1]);
        mma_bf16(acc[n + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // ---- the row sums live spread over a quad; divide and store
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* op = o + b * geo.qsb + h * geo.qsh;
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < geo.Sq)
      *reinterpret_cast<uint32_t*>(op + r0 * geo.qss + c) = pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < geo.Sq)
      *reinterpret_cast<uint32_t*>(op + r1 * geo.qss + c) = pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

// ---- f32: 32 query rows by 16 keys per step; thread (row tid/4, quarter
// tid%4) scores 4 keys of its row and accumulates every 4th output column
constexpr int FQ = 32, FK = 16;

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, Geometry geo) {
  __shared__ float sQ[FQ][D];
  __shared__ float sK[FK][D + 1];
  __shared__ float sV[FK][D];
  __shared__ float sP[FQ][FK];
  const int bh = blockIdx.x, b = bh / geo.Hq, h = bh % geo.Hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FQ;
  const int tid = threadIdx.x, r = tid / 4, qd = tid % 4, row = q0 + r;
  const float* qp = q + b * geo.qsb + h * geo.qsh;
  const float* kp = k + b * geo.ksb + (h / geo.G) * geo.ksh;
  const float* vp = v + b * geo.ksb + (h / geo.G) * geo.ksh;
  for (int i = tid; i < FQ * D; i += THREADS) {
    const int rr = i / D, c = i % D;
    sQ[rr][c] = q0 + rr < geo.Sq ? qp[(q0 + rr) * geo.qss + c] : 0.f;
  }
  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;
  float m = NEG_INF, l = 0.f;
  int jlo, jhi;
  tile_range(q0, min(q0 + FQ, geo.Sq) - 1, FK, geo, &jlo, &jhi);
  for (int j = jlo; j <= jhi; ++j) {
    const int k0 = j * FK;
    __syncthreads();  // the previous step is done with sK, sV, sP
    for (int i = tid; i < FK * D; i += THREADS) {
      const int rr = i / D, c = i % D;
      const bool p = k0 + rr < geo.Sk;
      sK[rr][c] = p ? kp[(k0 + rr) * geo.kss + c] : 0.f;
      sV[rr][c] = p ? vp[(k0 + rr) * geo.kss + c] : 0.f;
    }
    __syncthreads();
    float s[4], mx = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = qd * 4 + jj;
      float dot = 0.f;
      for (int e = 0; e < D; ++e) dot = fmaf(sQ[r][e], sK[c][e], dot);
      s[jj] = live(row, k0 + c, geo) ? dot * geo.scale : NEG_INF;
      mx = fmaxf(mx, s[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m, mx), corr = expf(m - mn);
    m = mn;
    float ps = 0.f;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float p = expf(s[jj] - mn);
      sP[r][qd * 4 + jj] = p;
      ps += p;
    }
    l = l * corr + ps;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      float a = acc[i] * corr;
      for (int c = 0; c < FK; ++c) a = fmaf(sP[r][c], sV[c][qd + 4 * i], a);
      acc[i] = a;
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (row < geo.Sq) {
    float* op = o + b * geo.qsb + h * geo.qsh + row * geo.qss;
    const float lm = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < D / 4; ++i) op[qd + 4 * i] = acc[i] / lm;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, const Geometry& geo,
           int dt, cudaStream_t s) {
  if (dt == BF16) {
    constexpr int smem = bf16_smem_bytes<D>();
    cudaError_t e = cudaFuncSetAttribute(flash_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid(B * geo.Hq, (geo.Sq + BQ - 1) / BQ);
    flash_bf16_kernel<D><<<grid, THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), geo);
  } else if (dt == F32) {
    dim3 grid(B * geo.Hq, (geo.Sq + FQ - 1) / FQ);
    flash_f32_kernel<D><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), geo);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ep_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  int B, int Hq, int Hkv, int Sq, int Sk, int D,
                                  int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb,
                                  int64_t ksh, int64_t kss, float scale, int window,
                                  int causal, int dt, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return static_cast<int>(cudaGetLastError());
  if (Hkv <= 0 || Hq % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry geo{Sq, Sk, Hq / Hkv, Hq, qsb, qsh, qss, ksb, ksh, kss, scale, window,
                     causal != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch<128>(q, k, v, o, B, geo, dt, s);
  if (D == 64) return launch<64>(q, k, v, o, B, geo, dt, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
