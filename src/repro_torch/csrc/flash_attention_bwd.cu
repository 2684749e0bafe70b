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
// Two kernels a call, dQ first: it writes delta, which dK/dV reads. At
// training lengths the pair is bound by the tensor cores: five products of
// 2·d operations per live pair (seven with the recomputation below) against
// one read of Q, K, V, O, dO and one write of dQ, dK, dV.
//
// bf16: two warp-specialised kernels for sm_90a in the forward's shape
// (flash_attention.cu, FlashAttention-3's structure): a persistent grid of
// one block per SM; one producer thread issues TMA loads through 4-D maps
// over the model's [B, S, H, d] (64-column boxes, 128-byte swizzle, zeros
// past S in each batch) into rings under full/empty mbarriers; two consumer
// warpgroups (setmaxnreg 232, the producer 40) run every product on
// wgmma.mma_async with f32 accumulators in registers.
//   * dQ: a work tile is 128 query rows of one (batch, query head), 64 per
//     warpgroup, walked heaviest first (the last rows of a causal sequence)
//     with heads fastest, as the forward. A tile first takes delta of its
//     rows from O and dO and writes it, then walks the KV tiles of 128 keys
//     its rows reach (the forward's walk), K and V in a two-stage ring:
//     S = Q·Kᵀ and dP = dO·Vᵀ from shared memory, both K-major as stored;
//     P = exp2(S·scale·log2e - lse·log2e) and dS = P (dP - delta) in
//     registers; dQ += dS·K with dS rounded to bf16 as wgmma's register A
//     fragment and K read MN-major (transpose-B).
//   * dK/dV: a work tile is 128 keys of one (batch, kv head), 64 per
//     warpgroup, walked heaviest first (the first keys of a causal
//     sequence). It walks the G query heads of its kv head and, for each,
//     the query tiles of 64 rows that reach its keys, so GQA's sum stays in
//     the block; Q, dO and each row's lse and delta (a producer warp's
//     loads) arrive in a two-stage ring. It computes the transposed
//     products, so that no operand needs wgmma's transpose-A: Sᵀ = K·Qᵀ and
//     dPᵀ = V·dOᵀ (K-major), Pᵀ and dSᵀ in registers, dV += Pᵀ·dO and
//     dK += dSᵀ·Q with Pᵀ and dSᵀ in bf16 as register A fragments and dO and
//     Q read MN-major.
//   Tiles that no live pair reaches are never loaded; only the tiles that
//   cross the diagonal, the window's edge or a tail test each element.
//   log2(e) folds into lse as it is loaded, never into the stored tensor.
//   The epilogues stage bf16 rows in the store box's swizzled layout and
//   write them by TMA (rows past S are not written); a tile that no live
//   pair reaches writes zeros. Rounding P and dS to bf16 before their
//   products is the only rounding the plain version does not make.
//   kernels/flash_attention.py mirrors both walks (tile_coords, kv_tiles;
//   dkv_tile_coords, q_tiles) for the CPU tests.
// f32: two kernels on the CUDA cores in exact f32, tiles of 64 queries by 64
// keys in shared memory: one block per 64 query rows for delta and dQ, one
// per 64 keys of a (batch, kv head) for dK and dV.
// No atomics in either: every output element is summed by one block in a
// fixed order, so two calls give the same bits.
//
// f32 thread layout (256 threads): thread (ty, tx) = (t / 16, t % 16) owns
// rows ty + 16 i (i < 4) and columns tx + 16 j of a 64-wide product, so a
// warp reads two rows (broadcast) and sixteen consecutive columns (distinct
// banks) of the padded shared tiles.
#include "hopper.cuh"

namespace {

// ---- f32
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
__device__ __forceinline__ void st(float* p, int64_t i, float v) { p[i] = v; }

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

// ---- bf16
constexpr int BQ = 128, BKV = 128;   // dQ: query rows per work tile, keys per KV tile
constexpr int BKEY = 128, BQT = 64;  // dK/dV: keys per work tile, query rows per step
constexpr int STAGES = 2;            // ring depth
constexpr int CHUNK = 64;            // TMA box width: one 128-byte swizzled row
constexpr int CONSUMERS = 256;       // two consumer warpgroups, then one producer
constexpr int WS_THREADS = CONSUMERS + 128;
constexpr int EPI = 1;               // named barrier EPI + w: warpgroup w's epilogue
constexpr int O_BOX = 64 * CHUNK * 2;  // 8 KB: one 64-column box of a warpgroup's rows

template <int D>
struct DqCfg {
  static constexpr int Q_BOX = BQ * CHUNK * 2;       // 16 KB: 64 columns of 128 rows
  static constexpr int KV_BOX = BKV * CHUNK * 2;
  static constexpr int Q_BYTES = Q_BOX * (D / CHUNK);
  static constexpr int KV_BYTES = KV_BOX * (D / CHUNK);
  static constexpr int O_HALF = O_BOX * (D / CHUNK);
  static constexpr int BARS = 2 + 2 * STAGES;        // q full/empty, kv full/empty
  static constexpr int SMEM = 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 2 * O_HALF + BARS * 8 + 1024;
  static constexpr int ACC = D / 2;                  // dQ accumulators a thread
};

template <int D>
struct DkvCfg {
  static constexpr int KT_BOX = BKEY * CHUNK * 2;    // 16 KB: 64 columns of 128 keys
  static constexpr int QT_BOX = BQT * CHUNK * 2;     // 8 KB: 64 columns of 64 rows
  static constexpr int KT_BYTES = KT_BOX * (D / CHUNK);
  static constexpr int QT_BYTES = QT_BOX * (D / CHUNK);
  static constexpr int O_HALF = O_BOX * (D / CHUNK);
  static constexpr int STAGE = 2 * QT_BYTES;         // Q, then dO
  static constexpr int ROWS = STAGES * 2 * BQT * 4;  // each stage's lse (log2) and delta
  static constexpr int BARS = 2 + 2 * STAGES;        // kv full/empty, stage full/empty
  static constexpr int SMEM =
      2 * KT_BYTES + STAGES * STAGE + 4 * O_HALF + ROWS + BARS * 8 + 1024;
  static constexpr int ACC = D / 2;                  // dK and dV accumulators a thread
};

// The geometry and both walks' sizes.
struct Plan {
  Geo g;
  int m_tiles, dq_tiles;   // 128-row query tiles of a sequence; dQ work tiles
  int n_tiles, dkv_tiles;  // 128-key tiles of a sequence; dK/dV work tiles
};

// dQ work tile t -> (batch, query head, first row), heaviest first: under a
// causal mask the last query tiles reach the most keys. Heads run fastest.
// kernels/flash_attention.py tile_coords is the same map.
__device__ __forceinline__ void dq_coords(const Plan& p, int t, int& b, int& h, int& q0) {
  const int bh = p.g.B * p.g.Hq;
  const int mt = p.g.causal ? p.m_tiles - 1 - t / bh : t / bh, r = t % bh;
  b = r / p.g.Hq;
  h = r % p.g.Hq;
  q0 = mt * BQ;
}

// dK/dV work tile t -> (batch, kv head, first key), heaviest first: under a
// causal mask the first keys are reached by the most rows, without one the
// last. kernels/flash_attention.py dkv_tile_coords is the same map.
__device__ __forceinline__ void dkv_coords(const Plan& p, int t, int& b, int& kvh, int& k0) {
  const int bk = p.g.B * p.g.Hkv;
  const int nt = p.g.causal ? t / bk : p.n_tiles - 1 - t / bk, r = t % bk;
  b = r / p.g.Hkv;
  kvh = r % p.g.Hkv;
  k0 = nt * BKEY;
}

// The KV tiles that rows [q0, min(q0 + BQ, Sq)) reach: the forward's
// tile_range (kernels/flash_attention.py kv_tiles).
__device__ __forceinline__ void kv_range(const Geo& g, int q0, int& lo, int& hi) {
  const int q_last = min(q0 + BQ, g.Sq) - 1, nk = (g.Sk + BKV - 1) / BKV;
  hi = g.causal ? min(nk - 1, q_last / BKV) : nk - 1;
  lo = 0;
  if (g.window > 0) {  // tile j is live iff q0 - (j*BKV + BKV - 1) < window
    const int first = q0 - g.window - BKV + 2;
    if (first > 0) lo = (first + BKV - 1) / BKV;
  }
}

// Whether KV tile j needs the per-element mask for the dQ tile at q0: it
// crosses Sk's tail, the causal diagonal or the window's far edge.
__device__ __forceinline__ bool kv_masked(const Geo& g, int q0, int j) {
  const int q_last = min(q0 + BQ, g.Sq) - 1, k0 = j * BKV, k_last = k0 + BKV - 1;
  return k_last >= g.Sk || (g.causal && k_last > q0) ||
         (g.window > 0 && q_last - k0 >= g.window);
}

// The query tiles of BQT rows that keys [k0, min(k0 + BKEY, Sk)) meet
// (kernels/flash_attention.py q_tiles).
__device__ __forceinline__ void q_range(const Geo& g, int k0, int& lo, int& hi) {
  const int k_last = min(k0 + BKEY, g.Sk) - 1;
  lo = g.causal ? k0 / BQT : 0;
  hi = (g.Sq + BQT - 1) / BQT - 1;
  if (g.window > 0 && g.window <= g.Sq) hi = min(hi, (k_last + g.window - 1) / BQT);
}

// Whether query tile i needs the per-element mask against keys [k0, k0 +
// BKEY): it crosses Sq's or Sk's tail, the diagonal or the window's edge.
__device__ __forceinline__ bool q_masked(const Geo& g, int k0, int i) {
  const int q0 = i * BQT, q_end = q0 + BQT - 1, k_end = k0 + BKEY - 1;
  return q_end >= g.Sq || k_end >= g.Sk || (g.causal && k_end > q0) ||
         (g.window > 0 && q_end - k0 >= g.window);
}

__device__ __forceinline__ int stage_of(int it) { return it % STAGES; }
__device__ __forceinline__ uint32_t phase_of(int it) { return (it / STAGES) & 1; }

__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  if (lane == 0) mbar_arrive(bar);
}

// A shared-memory address as an opaque value where a product uses it:
// otherwise the compiler keeps every descriptor of the loop-invariant
// operands (Q, dO, K, V) live across the whole walk, and spills.
__device__ __forceinline__ void opaque(uint32_t& a) { asm volatile("" : "+r"(a)); }

// acc = A·Bᵀ over D columns (accumulators overwritten): A this warpgroup's
// 64 rows at `a`, B N rows at `b`, both K-major as stored. 16 columns a
// step are 32 bytes along the swizzled row; 64-column boxes A_BOX and B_BOX
// apart; 8-row groups 1024 bytes apart.
template <int D, int N, int A_BOX, int B_BOX>
__device__ __forceinline__ void mma_abt(float* acc, uint32_t a, uint32_t b) {
  opaque(a);
  opaque(b);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = sw128_desc(a + (kk / 4) * A_BOX + (kk % 4) * 32, 16, 1024);
    const uint64_t db = sw128_desc(b + (kk / 4) * B_BOX + (kk % 4) * 32, 16, 1024);
    if constexpr (N == 128) wgmma_ss_n128<0>(acc, da, db, kk > 0);
    else wgmma_ss_n64<0>(acc, da, db, kk > 0);
  }
}

// acc += A·B over K rows: A from registers (registers 4kk..4kk+3 cover rows
// 16kk.. of B), B's K rows of 128 bytes at `b`, its D columns MN-major in
// 64-column boxes B_BOX apart; 8-row groups 1024 bytes apart.
template <int D, int K, int B_BOX>
__device__ __forceinline__ void mma_rs(float* acc, const uint32_t* a, uint32_t b) {
  opaque(b);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t db = sw128_desc(b + kk * 16 * 128, B_BOX, 1024);
    if constexpr (D == 128) wgmma_rs_n128(acc, a + 4 * kk, db, 1);
    else wgmma_rs_n64(acc, a + 4 * kk, db, 1);
  }
}

// rowsum(dO * O) over the quarter `part` of row r's D columns (0 past Sq):
// a quad of lanes shares a row, and sums its quarters with two shuffles.
template <int D>
__device__ __forceinline__ float row_dot(const __nv_bfloat16* o, const __nv_bfloat16* dout,
                                         const Geo& g, int b, int h, int r, int part) {
  float acc = 0.f;
  if (r < g.Sq) {
    const int64_t base =
        ((static_cast<int64_t>(b) * g.Sq + r) * g.Hq + h) * D + part * (D / 4);
#pragma unroll
    for (int v = 0; v < D / 32; ++v) {
      const uint4 a = *reinterpret_cast<const uint4*>(o + base + 8 * v);
      const uint4 c = *reinterpret_cast<const uint4*>(dout + base + 8 * v);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(a2[e]), y = __bfloat1622float2(c2[e]);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc;
}

// dQ's P and dS over one S tile (m64n128): register i holds row r0 + 8 *
// ((i / 2) % 2), key c0 + 8 * (i / 4) + i % 2. dS (in dp) rounded to bf16
// as wgmma's A fragments: registers 4kk..4kk+3 cover keys 16kk..16kk+15.
template <bool MASK>
__device__ __forceinline__ void dq_scores(const float* s, float* dp, uint32_t* ds, const Geo& g,
                                          float sl2, int r0, int c0, float l0, float l1,
                                          float d0, float d1) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int h = (i >> 1) & 1;
    float p = ex2(fmaf(s[i], sl2, -(h ? l1 : l0)));
    if constexpr (MASK)
      if (!live(r0 + 8 * h, c0 + 8 * (i >> 2) + (i & 1), g)) p = 0.f;
    dp[i] = p * (dp[i] - (h ? d1 : d0));
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) ds[i] = pack_bf16x2(dp[2 * i], dp[2 * i + 1]);
}

// dK/dV's Pᵀ and dSᵀ over one Sᵀ tile (m64n64): register i holds key
// key0 + 8 * ((i / 2) % 2), query q0 + c with c = cq + 8 * (i / 4) + i % 2;
// lse2 (log2 domain) and delta of the stage's rows by c. Both rounded to
// bf16 as A fragments: registers 4kk..4kk+3 cover queries 16kk..16kk+15.
template <bool MASK>
__device__ __forceinline__ void dkv_scores(float* s, float* dp, uint32_t* pt, uint32_t* dst,
                                           const Geo& g, float sl2, int key0, int q0, int cq,
                                           const float* lse2, const float* delta) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1, c = cq + 8 * (i >> 2) + (i & 1);
    float p = ex2(fmaf(s[i], sl2, -lse2[c]));
    if constexpr (MASK)
      if (!live(q0 + c, key0 + 8 * h, g)) p = 0.f;
    s[i] = p;
    dp[i] = p * (dp[i] - delta[c]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    pt[i] = pack_bf16x2(s[2 * i], s[2 * i + 1]);
    dst[i] = pack_bf16x2(dp[2 * i], dp[2 * i + 1]);
  }
}

// A warpgroup's 64 x D accumulator times `mul`, in bf16, into a staging
// buffer in the store box's swizzled layout (64-column boxes O_BOX apart).
template <int D>
__device__ __forceinline__ void stage_rows(uint8_t* dst, const float* acc, float mul, int warp,
                                           int lane) {
  const int cq = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int hh = (i >> 1) & 1, j = i >> 2;      // row half, 8-column group
    const int r = 16 * warp + lane / 4 + 8 * hh;  // row of the warpgroup's 64
    const int off = (j / 8) * O_BOX + r * 128 + (((j % 8) ^ (r % 8)) << 4) + cq * 2;
    *reinterpret_cast<uint32_t*>(dst + off) = pack_bf16x2(acc[i] * mul, acc[i + 1] * mul);
  }
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  // the 128-byte swizzle repeats every 1024 bytes: align the buffers to it
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdq, const Plan p,
                         const __nv_bfloat16* __restrict__ o,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse, float* __restrict__ delta) {
  using C = DqCfg<D>;
  const Geo& g = p.g;
  extern __shared__ uint8_t smem_ws[];  // the f32 kernels declare it as float4
  uint8_t* sq = align1024(smem_ws);
  uint8_t* sdo = sq + C::Q_BYTES;
  uint8_t* sk = sdo + C::Q_BYTES;
  uint8_t* sv = sk + STAGES * C::KV_BYTES;
  uint8_t* so = sv + STAGES * C::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(so + 2 * C::O_HALF);
  uint64_t* q_empty = q_full + 1;
  uint64_t* kv_full = q_full + 2;
  uint64_t* kv_empty = kv_full + STAGES;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);                // the producer's expect_tx
    mbar_init(q_empty, CONSUMERS / 32);  // one arrival per consumer warp
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&kv_full[i], 1);
      mbar_init(&kv_empty[i], CONSUMERS / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  // warp-uniform by construction, so that wgmma never sits on a path the
  // compiler must treat as divergent (it would serialise them)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (wg == 2) {  // ---- producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != CONSUMERS) return;
    int it = 0;
    uint32_t qph = 0;
    for (int t = blockIdx.x; t < p.dq_tiles; t += gridDim.x) {
      int b, h, q0, lo, hi;
      dq_coords(p, t, b, h, q0);
      kv_range(g, q0, lo, hi);
      if (lo > hi) continue;  // no key reaches the tile: nothing is loaded
      const int kvh = h / g.G;
      mbar_wait(q_empty, qph ^ 1);
      qph ^= 1;
      mbar_expect_tx(q_full, 2 * C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < D / CHUNK; ++c) {
        tma_load_4d(sq + c * C::Q_BOX, &tq, q_full, c * CHUNK, h, q0, b);
        tma_load_4d(sdo + c * C::Q_BOX, &tdo, q_full, c * CHUNK, h, q0, b);
      }
      for (int j = hi; j >= lo; --j, ++it) {  // the forward's order: last first
        const int st = stage_of(it);
        mbar_wait(&kv_empty[st], phase_of(it) ^ 1);
        mbar_expect_tx(&kv_full[st], 2 * C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < D / CHUNK; ++c) {
          tma_load_4d(sk + st * C::KV_BYTES + c * C::KV_BOX, &tk, &kv_full[st], c * CHUNK, kvh,
                      j * BKV, b);
          tma_load_4d(sv + st * C::KV_BYTES + c * C::KV_BOX, &tv, &kv_full[st], c * CHUNK, kvh,
                      j * BKV, b);
        }
      }
    }
  } else {  // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of a tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
    const float sl2 = g.scale * LOG2E;
    const uint32_t q_wg = smem_u32(sq) + wg * (64 * 128), do_wg = smem_u32(sdo) + wg * (64 * 128);
    const uint32_t k_ring = smem_u32(sk), v_ring = smem_u32(sv);
    uint8_t* so_wg = so + wg * C::O_HALF;
    int it = 0;
    uint32_t qph = 0;
    float dq[C::ACC], s[64], dp[64];
    uint32_t ds[32];
    for (int t = blockIdx.x; t < p.dq_tiles; t += gridDim.x) {
      int b, h, q0, lo, hi;
      dq_coords(p, t, b, h, q0);
      kv_range(g, q0, lo, hi);
      const int r0 = q0 + 64 * wg + 16 * warp + lane / 4;  // this thread's rows r0, r0 + 8
      const int cq = 2 * (lane % 4);
      // delta of rows r0 and r0 + 8, written once; lse in the log2 domain
      const float d0 = row_dot<D>(o, dout, g, b, h, r0, lane % 4);
      const float d1 = row_dot<D>(o, dout, g, b, h, r0 + 8, lane % 4);
      const int64_t lrow = static_cast<int64_t>(b * g.Hq + h) * g.Sq;
      float l0 = 0.f, l1 = 0.f;
      if (r0 < g.Sq) {
        l0 = lse[lrow + r0] * LOG2E;
        if (lane % 4 == 0) delta[lrow + r0] = d0;
      }
      if (r0 + 8 < g.Sq) {
        l1 = lse[lrow + r0 + 8] * LOG2E;
        if (lane % 4 == 0) delta[lrow + r0 + 8] = d1;
      }
#pragma unroll
      for (int i = 0; i < C::ACC; ++i) dq[i] = 0.f;
      if (lo <= hi) {
        mbar_wait(q_full, qph);
        qph ^= 1;
        for (int j = hi; j >= lo; --j, ++it) {
          const int st = stage_of(it);
          const uint32_t ks = k_ring + st * C::KV_BYTES, vs = v_ring + st * C::KV_BYTES;
          mbar_wait(&kv_full[st], phase_of(it));
          wgmma_fence();
          mma_abt<D, BKV, C::Q_BOX, C::KV_BOX>(s, q_wg, ks);    // S = Q·Kᵀ
          mma_abt<D, BKV, C::Q_BOX, C::KV_BOX>(dp, do_wg, vs);  // dP = dO·Vᵀ
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<64>(s);
          fence_regs<64>(dp);
          if (j == lo) release(q_empty, lane);
          if (kv_masked(g, q0, j))
            dq_scores<true>(s, dp, ds, g, sl2, r0, j * BKV + cq, l0, l1, d0, d1);
          else
            dq_scores<false>(s, dp, ds, g, sl2, r0, j * BKV + cq, l0, l1, d0, d1);
          wgmma_fence();
          mma_rs<D, BKV, C::KV_BOX>(dq, ds, ks);  // dQ += dS·K
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<C::ACC>(dq);
          fence_regs<32>(ds);
          release(&kv_empty[st], lane);
        }
      }
      // ---- epilogue: scale, round, stage in the store box's swizzled
      // layout, store by TMA (rows past Sq are not written)
      if (tw == 0) bulk_wait_read<0>();  // the last tile's store has left the buffer
      bar_sync(EPI + wg, 128);
      stage_rows<D>(so_wg, dq, g.scale, warp, lane);
      fence_proxy_async();
      bar_sync(EPI + wg, 128);
      if (tw == 0 && q0 + 64 * wg < g.Sq) {
#pragma unroll
        for (int c = 0; c < D / CHUNK; ++c)
          tma_store_4d(&tdq, so_wg + c * O_BOX, c * CHUNK, h, q0 + 64 * wg, b);
        bulk_commit();
      }
    }
    if (tw == 0) bulk_wait_read<0>();
  }
}

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdk,
                           const __grid_constant__ CUtensorMap tdv, const Plan p,
                           const float* __restrict__ lse, const float* __restrict__ delta) {
  using C = DkvCfg<D>;
  const Geo& g = p.g;
  extern __shared__ uint8_t smem_ws[];  // the f32 kernels declare it as float4
  uint8_t* sk = align1024(smem_ws);
  uint8_t* sv = sk + C::KT_BYTES;
  uint8_t* ring = sv + C::KT_BYTES;
  uint8_t* so = ring + STAGES * C::STAGE;
  float* rows = reinterpret_cast<float*>(so + 4 * C::O_HALF);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(rows + STAGES * 2 * BQT);
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* full = kv_full + 2;
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, CONSUMERS / 32);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1 + 32);  // the expect_tx, then each producer lane's rows
      mbar_init(&empty[i], CONSUMERS / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (wg == 2) {  // ---- producer: lane 0 issues the TMA loads, the warp the rows
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x >= CONSUMERS + 32) return;
    const int lane = threadIdx.x % 32;
    int it = 0;
    uint32_t kvph = 0;
    for (int t = blockIdx.x; t < p.dkv_tiles; t += gridDim.x) {
      int b, kvh, k0, lo, hi;
      dkv_coords(p, t, b, kvh, k0);
      q_range(g, k0, lo, hi);
      if (lo > hi) continue;  // no row reaches the keys: nothing is loaded
      if (lane == 0) {
        mbar_wait(kv_empty, kvph ^ 1);
        mbar_expect_tx(kv_full, 2 * C::KT_BYTES);
#pragma unroll
        for (int c = 0; c < D / CHUNK; ++c) {
          tma_load_4d(sk + c * C::KT_BOX, &tk, kv_full, c * CHUNK, kvh, k0, b);
          tma_load_4d(sv + c * C::KT_BOX, &tv, kv_full, c * CHUNK, kvh, k0, b);
        }
      }
      kvph ^= 1;
      for (int gi = 0; gi < g.G; ++gi) {
        const int h = kvh * g.G + gi;
        const int64_t lrow = static_cast<int64_t>(b * g.Hq + h) * g.Sq;
        for (int i = lo; i <= hi; ++i, ++it) {
          const int st = stage_of(it);
          uint8_t* qs = ring + st * C::STAGE;
          mbar_wait(&empty[st], phase_of(it) ^ 1);
          if (lane == 0) {
            mbar_expect_tx(&full[st], C::STAGE);
#pragma unroll
            for (int c = 0; c < D / CHUNK; ++c) {
              tma_load_4d(qs + c * C::QT_BOX, &tq, &full[st], c * CHUNK, h, i * BQT, b);
              tma_load_4d(qs + C::QT_BYTES + c * C::QT_BOX, &tdo, &full[st], c * CHUNK, h,
                          i * BQT, b);
            }
          }
          float* rl = rows + st * 2 * BQT;
          for (int x = lane; x < BQT; x += 32) {
            const int r = i * BQT + x;
            rl[x] = r < g.Sq ? lse[lrow + r] * LOG2E : 0.f;
            rl[BQT + x] = r < g.Sq ? delta[lrow + r] : 0.f;
          }
          mbar_arrive(&full[st]);
        }
      }
    }
  } else {  // ---- consumers: warpgroup wg owns keys [64 wg, 64 wg + 64) of a tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
    const float sl2 = g.scale * LOG2E;
    const uint32_t k_wg = smem_u32(sk) + wg * (64 * 128), v_wg = smem_u32(sv) + wg * (64 * 128);
    const uint32_t ring_s = smem_u32(ring);
    uint8_t* so_wg = so + wg * 2 * C::O_HALF;
    int it = 0;
    uint32_t kvph = 0;
    float dk[C::ACC], dv[C::ACC], s[32], dp[32];
    uint32_t pt[16], dst[16];
    for (int t = blockIdx.x; t < p.dkv_tiles; t += gridDim.x) {
      int b, kvh, k0, lo, hi;
      dkv_coords(p, t, b, kvh, k0);
      q_range(g, k0, lo, hi);
      const int key0 = k0 + 64 * wg + 16 * warp + lane / 4;  // this thread's keys key0, key0 + 8
      const int cq = 2 * (lane % 4);
#pragma unroll
      for (int i = 0; i < C::ACC; ++i) dk[i] = dv[i] = 0.f;
      if (lo <= hi) {
        mbar_wait(kv_full, kvph);
        kvph ^= 1;
        for (int gi = 0; gi < g.G; ++gi) {
          for (int i = lo; i <= hi; ++i, ++it) {
            const int st = stage_of(it);
            const uint32_t qs = ring_s + st * C::STAGE, dos = qs + C::QT_BYTES;
            const float* rl = rows + st * 2 * BQT;
            mbar_wait(&full[st], phase_of(it));
            wgmma_fence();
            mma_abt<D, BQT, C::KT_BOX, C::QT_BOX>(s, k_wg, qs);    // Sᵀ = K·Qᵀ
            mma_abt<D, BQT, C::KT_BOX, C::QT_BOX>(dp, v_wg, dos);  // dPᵀ = V·dOᵀ
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs<32>(s);
            fence_regs<32>(dp);
            if (q_masked(g, k0, i))
              dkv_scores<true>(s, dp, pt, dst, g, sl2, key0, i * BQT, cq, rl, rl + BQT);
            else
              dkv_scores<false>(s, dp, pt, dst, g, sl2, key0, i * BQT, cq, rl, rl + BQT);
            wgmma_fence();
            mma_rs<D, BQT, C::QT_BOX>(dv, pt, dos);  // dV += Pᵀ·dO
            mma_rs<D, BQT, C::QT_BOX>(dk, dst, qs);  // dK += dSᵀ·Q
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs<C::ACC>(dv);
            fence_regs<C::ACC>(dk);
            fence_regs<16>(pt);
            fence_regs<16>(dst);
            release(&empty[st], lane);
          }
        }
        release(kv_empty, lane);
      }
      // ---- epilogue: dK scaled and dV, rounded, staged and stored by TMA
      // (keys past Sk are not written)
      if (tw == 0) bulk_wait_read<0>();
      bar_sync(EPI + wg, 128);
      stage_rows<D>(so_wg, dk, g.scale, warp, lane);
      stage_rows<D>(so_wg + C::O_HALF, dv, 1.f, warp, lane);
      fence_proxy_async();
      bar_sync(EPI + wg, 128);
      if (tw == 0 && k0 + 64 * wg < g.Sk) {
#pragma unroll
        for (int c = 0; c < D / CHUNK; ++c) {
          tma_store_4d(&tdk, so_wg + c * O_BOX, c * CHUNK, kvh, k0 + 64 * wg, b);
          tma_store_4d(&tdv, so_wg + C::O_HALF + c * O_BOX, c * CHUNK, kvh, k0 + 64 * wg, b);
        }
        bulk_commit();
      }
    }
    if (tw == 0) bulk_wait_read<0>();
  }
}

// A 4-D bf16 map over a contiguous [B, S, H, d] (dims d, H, S, B) with boxes
// of 64 columns by `rows` rows of one head of one batch.
bool encode_bshd(CUtensorMap* map, const void* base, int B, int S, int H, int D, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(H) * D * 2,
                                 static_cast<cuuint64_t>(S) * H * D * 2};
  const cuuint32_t box[4] = {CHUNK, 1, static_cast<cuuint32_t>(rows), 1};
  return encode_bf16(map, 4, base, dims, strides, box);
}

// The shared-memory limits are raised, and the SM count read, once per
// device and instance before its first launch.
template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, void* delta, void* dq, void* dk,
                        void* dv, const Geo& g, cudaStream_t st) {
  static bool sized[MAX_DEVICES] = {};
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!sized[dev]) {
    e = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, DqCfg<D>::SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dkdv_bf16_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, DkvCfg<D>::SMEM);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    sized[dev] = true;
  }
  Plan p{g, (g.Sq + BQ - 1) / BQ, 0, (g.Sk + BKEY - 1) / BKEY, 0};
  p.dq_tiles = g.B * g.Hq * p.m_tiles;
  p.dkv_tiles = g.B * g.Hkv * p.n_tiles;
  CUtensorMap tq{}, tdo{}, tk{}, tv{}, tdq{}, tq64{}, tdo64{}, tdk{}, tdv{};
  if (!encode_bshd(&tq, q, g.B, g.Sq, g.Hq, D, BQ) ||
      !encode_bshd(&tdo, dout, g.B, g.Sq, g.Hq, D, BQ) ||
      !encode_bshd(&tdq, dq, g.B, g.Sq, g.Hq, D, 64) ||
      !encode_bshd(&tq64, q, g.B, g.Sq, g.Hq, D, BQT) ||
      !encode_bshd(&tdo64, dout, g.B, g.Sq, g.Hq, D, BQT))
    return cudaErrorInvalidValue;
  if (g.Sk > 0 && (!encode_bshd(&tk, k, g.B, g.Sk, g.Hkv, D, BKV) ||
                   !encode_bshd(&tv, v, g.B, g.Sk, g.Hkv, D, BKV) ||
                   !encode_bshd(&tdk, dk, g.B, g.Sk, g.Hkv, D, 64) ||
                   !encode_bshd(&tdv, dv, g.B, g.Sk, g.Hkv, D, 64)))
    return cudaErrorInvalidValue;
  const auto* lse_f = static_cast<const float*>(lse);
  auto* delta_f = static_cast<float*>(delta);
  const int dq_lanes = p.dq_tiles < sms[dev] ? p.dq_tiles : sms[dev];
  flash_bwd_dq_bf16_kernel<D><<<dq_lanes, WS_THREADS, DqCfg<D>::SMEM, st>>>(
      tq, tdo, tk, tv, tdq, p, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse_f, delta_f);
  e = cudaGetLastError();
  if (e != cudaSuccess || g.Sk == 0) return e;
  const int dkv_lanes = p.dkv_tiles < sms[dev] ? p.dkv_tiles : sms[dev];
  flash_bwd_dkdv_bf16_kernel<D><<<dkv_lanes, WS_THREADS, DkvCfg<D>::SMEM, st>>>(
      tq64, tdo64, tk, tv, tdk, tdv, p, lse_f, delta_f);
  return cudaGetLastError();
}

// ---- f32: delta and dQ, then dK and dV
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
    e = launch_bf16<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, g, s);
  else if (dt == BF16 && D == 64)
    e = launch_bf16<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, g, s);
  else if (dt == F32 && D == 128)
    e = launch<float, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, g, s);
  else if (dt == F32 && D == 64)
    e = launch<float, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, g, s);
  return static_cast<int>(e);
}
