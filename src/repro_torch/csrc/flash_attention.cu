// flash_attention: causal (optionally sliding-window) GQA attention with an
// online softmax, for prefill and training forwards without a KV cache.
//
// Replaces src/repro/kernels/flash_attention.py:86 flash_attention (the
// Pallas kernel over a (B, Hq, Sq/bq, Sk/bk) grid whose innermost KV axis
// carries m, l and the accumulator in VMEM scratch). At prefill lengths it
// is bound by the tensor cores: 4·d operations per live (query, key) pair
// against one read of Q, K, V and one write of O.
//
// bf16: one warp-specialised kernel for sm_90a (FlashAttention-3's shape).
//   * Work: a tile is 128 query rows of one (batch, query head). A persistent
//     grid of one block per SM walks the tiles round-robin, heaviest query
//     tiles first (the last rows of a causal sequence reach the most keys),
//     heads fastest so that the G heads of one kv head run side by side and
//     share its K/V in L2. Each tile is done once, by one block, in a
//     fixed order: two calls give the same bits.
//   * Loads: one producer thread issues TMA loads through 4-D maps over the
//     model's [B, S, H, d] (dims d, H, S, B; strides from the tensors; 64-
//     column boxes, 128-byte swizzle), so a box past S in one batch arrives
//     as zeros and never reads the next. Q (128 rows) once per tile; K and V
//     tiles of 128 keys in two-stage rings under full/empty mbarriers, in the
//     order the consumers take them (K of tile i before V of tile i - 1).
//     KV tiles that no row of the tile reaches are never loaded.
//   * Products: two consumer warpgroups, 64 query rows each, on
//     wgmma.mma_async. S = Q·Kᵀ is m64n128k16 with both operands in shared
//     memory, K-major as stored. O += P·V takes P from registers (the S
//     accumulators rounded to bf16 are wgmma's A fragment) and V as stored,
//     MN-major through transpose-B. m, l and O stay in f32 registers.
//   * Overlap: inside a warpgroup, tile i's Q·Kᵀ and tile i - 1's P·V are in
//     flight while it waits for the first and then runs tile i's softmax;
//     between the two warpgroups, named barriers hand the tensor cores back
//     and forth (ping-pong), so one's softmax runs under the other's products.
//   * Masks only where they can bite: a KV tile wholly live for every row
//     of the tile takes no per-element test; the tiles that cross the
//     diagonal, the window's edge or Sk's tail do. The scale and log2(e) fold
//     into one multiply ahead of ex2.
//   * Epilogue: O / max(l, 1e-30) in bf16 into a swizzled staging buffer,
//     then one TMA store per 64-column box of each warpgroup's 64 rows (rows
//     past Sq are not written). When asked (training), each row's natural
//     log-sum-exp of its scaled scores, m + log(max(l, 1e-30)), in f32
//     [B, Hq, Sq], which the backward (flash_attention_bwd.cu) reads.
//   kernels/flash_attention.py mirrors the walk (tile_coords, kv_tiles,
//   lane_tiles) for the CPU tests.
//   Head width 96 (Phi-3-vision) runs the D = 128 instance over maps whose
//   inner extent is the real 96 columns: the second 64-column box of a load
//   reads columns 64 to 127 and TMA fills 96 to 127 with zeros, so Q·Kᵀ is
//   exact and P·V's last 32 columns are zero; the store of that box clips at
//   column 96. It spends a third more tensor-core work than a native 96 would.
// f32: a plain shared-memory kernel on the CUDA cores, exact f32 (d 64, 96
// or 128).
// GQA reads kv head h / G; nothing is repeated in memory. Masked scores are
// the finite -1e30 of the reference, so a row with no live key yet in a tile
// gets p = 1 on garbage that the first live key wipes exactly (corr = 0),
// where -inf would give NaN.
#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

struct Geometry {
  int Sq, Sk, G, Hq;
  int64_t qsb, qsh, qss;  // strides of q (and o) in elements: batch, head, seq
  int64_t ksb, ksh, kss;  // strides of k and v
  float scale;
  int window;             // <= 0: none
  bool causal;
  // bf16 walk: B * Hq, 128-row query tiles per sequence, work tiles
  int bh, m_tiles, tiles;
  float* lse;             // [B, Hq, Sq] f32 row log-sum-exp, or null: not written
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

// ---- bf16
constexpr int BQ = 128, BKV = 128;   // query rows per work tile, keys per KV tile
constexpr int STAGES = 2;            // K and V ring depth
constexpr int CHUNK = 64;            // TMA box width: one 128-byte swizzled row
constexpr int CONSUMERS = 256;       // two consumer warpgroups, then one producer
constexpr int THREADS = CONSUMERS + 128;
constexpr int SCHED = 1;             // named barrier SCHED + w: warpgroup w's turn
constexpr int EPI = 3;               // named barrier EPI + w: warpgroup w's epilogue

template <int D>
struct Cfg {
  static constexpr int Q_BOX = BQ * CHUNK * 2;      // 16 KB: 64 columns of 128 rows
  static constexpr int KV_BOX = BKV * CHUNK * 2;
  static constexpr int O_BOX = 64 * CHUNK * 2;      // 8 KB: a warpgroup's 64 rows
  static constexpr int Q_BYTES = Q_BOX * (D / CHUNK);
  static constexpr int KV_BYTES = KV_BOX * (D / CHUNK);
  static constexpr int O_HALF = O_BOX * (D / CHUNK);
  static constexpr int BARS = 2 + 4 * STAGES;       // q full/empty, k and v full/empty
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 2 * O_HALF + BARS * 8 + 1024;
  static constexpr int ACC = D / 2;                 // O accumulators a thread
  static_assert(Q_BOX == KV_BOX, "issue_qk steps through Q and K boxes alike");
};

// Work tile t -> (batch, query head, first row), heaviest first: under a
// causal mask the last query tiles reach the most keys, without one the
// first (a window cuts the keys before a tile, never after it). Heads run
// fastest. kernels/flash_attention.py tile_coords is the same map.
__device__ __forceinline__ void tile_coords(const Geometry& g, int t, int& b, int& h,
                                            int& q0) {
  const int mt = g.causal ? g.m_tiles - 1 - t / g.bh : t / g.bh, bh = t % g.bh;
  b = bh / g.Hq;
  h = bh % g.Hq;
  q0 = mt * BQ;
}

// Whether KV tile j needs the per-element mask for rows [q0, q_last]: it
// crosses Sk's tail, the causal diagonal or the window's far edge.
__device__ __forceinline__ bool kv_masked(const Geometry& g, int q0, int j) {
  const int q_last = min(q0 + BQ, g.Sq) - 1, k0 = j * BKV, k_last = k0 + BKV - 1;
  return k_last >= g.Sk || (g.causal && k_last > q0) ||
         (g.window > 0 && q_last - k0 >= g.window);
}

__device__ __forceinline__ int stage_of(int it) { return it % STAGES; }
__device__ __forceinline__ uint32_t phase_of(int it) { return (it / STAGES) & 1; }

// The producer's load of KV tile j (keys j * BKV ...) into ring slot `it`.
template <int D>
__device__ __forceinline__ void load_kv(uint64_t* full, uint64_t* empty, uint8_t* ring,
                                        const CUtensorMap* map, int it, int j, int kvh,
                                        int b) {
  const int st = stage_of(it);
  mbar_wait(&empty[st], phase_of(it) ^ 1);
  mbar_expect_tx(&full[st], Cfg<D>::KV_BYTES);
#pragma unroll
  for (int c = 0; c < D / CHUNK; ++c)
    tma_load_4d(ring + st * Cfg<D>::KV_BYTES + c * Cfg<D>::KV_BOX, map, &full[st],
                c * CHUNK, kvh, j * BKV, b);
}

// S = Q·Kᵀ for this warpgroup's 64 rows and the 128 keys of one K slot.
// Q: 16 columns a step are 32 bytes along the swizzled row; 64-column boxes
// Q_BOX apart; 8-row groups 1024 bytes apart. K the same, N-major.
template <int D>
__device__ __forceinline__ void issue_qk(float* s, uint32_t q, uint32_t k) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * Cfg<D>::Q_BOX + (kk % 4) * 32;
    wgmma_ss_n128<0>(s, sw128_desc(q + off, 16, 1024), sw128_desc(k + off, 16, 1024),
                     kk > 0);
  }
  wgmma_commit();
}

// O += P·V: key step kk takes P's registers 4kk..4kk+3 and V's rows 16kk..,
// 16 rows of 128 bytes; 64-column boxes KV_BOX apart, 8-row groups 1024.
template <int D>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t* p, uint32_t v) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    const uint64_t db = sw128_desc(v + kk * 16 * 128, Cfg<D>::KV_BOX, 1024);
    if constexpr (D == 128) wgmma_rs_n128(o, p + 4 * kk, db, 1);
    else wgmma_rs_n64(o, p + 4 * kk, db, 1);
  }
  wgmma_commit();
}

// Online softmax over one S tile in the log2 domain. Register i of the
// m64n128 accumulator holds row r0 + 8 * ((i / 2) % 2), column
// c0 + 8 * (i / 4) + i % 2 (c0 = the tile's first key + 2 * (lane % 4)); a
// quad of lanes shares a row. Leaves p (f32) in s and the correction of the
// old m in corr0, corr1.
template <bool MASK>
__device__ __forceinline__ void softmax(float* s, const Geometry& g, float sl2, int r0,
                                        int c0, float& m0, float& m1, float& l0, float& l1,
                                        float& corr0, float& corr1) {
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int h = (i >> 1) & 1;
    if constexpr (MASK)
      s[i] = live(r0 + 8 * h, c0 + 8 * (i >> 2) + (i & 1), g) ? s[i] * sl2 : NEG_INF;
    if (h) mx1 = fmaxf(mx1, s[i]);
    else mx0 = fmaxf(mx0, s[i]);
  }
  if constexpr (!MASK) {  // a positive scale commutes with the max
    mx0 *= sl2;
    mx1 *= sl2;
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
  corr0 = ex2(m0 - n0);
  corr1 = ex2(m1 - n1);
  m0 = n0;
  m1 = n1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int h = (i >> 1) & 1;
    const float mh = h ? n1 : n0;
    s[i] = MASK ? ex2(s[i] - mh) : ex2(fmaf(s[i], sl2, -mh));
    if (h) ps1 += s[i];
    else ps0 += s[i];
  }
  l0 = l0 * corr0 + ps0;
  l1 = l1 * corr1 + ps1;
}

// p as wgmma's A fragments: registers 4kk..4kk+3 cover keys 16kk..16kk+15.
__device__ __forceinline__ void to_p(const float* s, uint32_t* p) {
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = pack_bf16x2(s[2 * i], s[2 * i + 1]);
}

template <int D>
__device__ __forceinline__ void rescale(float* o, float corr0, float corr1) {
#pragma unroll
  for (int i = 0; i < Cfg<D>::ACC; ++i) o[i] *= ((i >> 1) & 1) ? corr1 : corr0;
}

__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  if (lane == 0) mbar_arrive(bar);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap to, const Geometry g) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the buffers to it
  uint8_t* sq = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sk = sq + C::Q_BYTES;
  uint8_t* sv = sk + STAGES * C::KV_BYTES;
  uint8_t* so = sv + STAGES * C::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(so + 2 * C::O_HALF);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_full + 2;
  uint64_t* k_empty = k_full + STAGES;
  uint64_t* v_full = k_empty + STAGES;
  uint64_t* v_empty = v_full + STAGES;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);                  // the producer's expect_tx
    mbar_init(q_empty, CONSUMERS / 32);    // one arrival per consumer warp
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&k_empty[i], CONSUMERS / 32);
      mbar_init(&v_full[i], 1);
      mbar_init(&v_empty[i], CONSUMERS / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  // warp-uniform by construction, so that wgmma never sits on a path the
  // compiler must treat as divergent (it would serialise them)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (wg == 2) {  // ---- producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x != CONSUMERS) return;
    int it = 0;
    uint32_t qph = 0;
    for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
      int b, h, q0, lo, hi;
      tile_coords(g, t, b, h, q0);
      tile_range(q0, min(q0 + BQ, g.Sq) - 1, BKV, g, &lo, &hi);
      if (lo > hi) continue;  // no key reaches the tile: nothing is loaded
      const int kvh = h / g.G;
      mbar_wait(q_empty, qph ^ 1);
      qph ^= 1;
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < D / CHUNK; ++c)
        tma_load_4d(sq + c * C::Q_BOX, &tq, q_full, c * CHUNK, h, q0, b);
      // KV tiles hi, hi - 1, ..., lo; K of each before V of the one before
      load_kv<D>(k_full, k_empty, sk, &tk, it, hi, kvh, b);
      for (int j = hi - 1; j >= lo; --j, ++it) {
        load_kv<D>(k_full, k_empty, sk, &tk, it + 1, j, kvh, b);
        load_kv<D>(v_full, v_empty, sv, &tv, it, j + 1, kvh, b);
      }
      load_kv<D>(v_full, v_empty, sv, &tv, it, lo, kvh, b);
      ++it;
    }
  } else {  // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of a tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
    const float sl2 = g.scale * LOG2E;
    const uint32_t q_wg = smem_u32(sq) + wg * (64 * 128);
    const uint32_t k_ring = smem_u32(sk), v_ring = smem_u32(sv);
    uint8_t* so_wg = so + wg * C::O_HALF;
    if (wg == 1) bar_arrive(SCHED + 0, CONSUMERS);  // warpgroup 0 issues first
    int it = 0;
    uint32_t qph = 0;
    float o[C::ACC], s[64];
    uint32_t p[32];
    for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
      int b, h, q0, lo, hi;
      tile_coords(g, t, b, h, q0);
      tile_range(q0, min(q0 + BQ, g.Sq) - 1, BKV, g, &lo, &hi);
      const int r0 = q0 + 64 * wg + 16 * warp + lane / 4;  // this thread's rows r0, r0 + 8
      const int cq = 2 * (lane % 4);
#pragma unroll
      for (int i = 0; i < C::ACC; ++i) o[i] = 0.f;
      float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f, corr0 = 1.f, corr1 = 1.f;
      if (lo <= hi) {
        mbar_wait(q_full, qph);
        qph ^= 1;
        // KV tile hi: S alone
        mbar_wait(&k_full[stage_of(it)], phase_of(it));
        bar_sync(SCHED + wg, CONSUMERS);
        issue_qk<D>(s, q_wg, k_ring + stage_of(it) * C::KV_BYTES);
        bar_arrive(SCHED + 1 - wg, CONSUMERS);
        wgmma_wait<0>();
        fence_regs<64>(s);
        release(&k_empty[stage_of(it)], lane);
        if (lo == hi) release(q_empty, lane);
        if (kv_masked(g, q0, hi))
          softmax<true>(s, g, sl2, r0, hi * BKV + cq, m0, m1, l0, l1, corr0, corr1);
        else
          softmax<false>(s, g, sl2, r0, hi * BKV + cq, m0, m1, l0, l1, corr0, corr1);
        to_p(s, p);
        for (int j = hi - 1; j >= lo; --j, ++it) {
          // S of tile j and P·V of tile j + 1 in flight together
          const int nx = it + 1;
          mbar_wait(&k_full[stage_of(nx)], phase_of(nx));
          bar_sync(SCHED + wg, CONSUMERS);
          issue_qk<D>(s, q_wg, k_ring + stage_of(nx) * C::KV_BYTES);
          rescale<D>(o, corr0, corr1);
          mbar_wait(&v_full[stage_of(it)], phase_of(it));
          issue_pv<D>(o, p, v_ring + stage_of(it) * C::KV_BYTES);
          bar_arrive(SCHED + 1 - wg, CONSUMERS);
          wgmma_wait<1>();  // S is done, P·V may still run
          fence_regs<64>(s);
          release(&k_empty[stage_of(nx)], lane);
          if (j == lo) release(q_empty, lane);
          if (kv_masked(g, q0, j))
            softmax<true>(s, g, sl2, r0, j * BKV + cq, m0, m1, l0, l1, corr0, corr1);
          else
            softmax<false>(s, g, sl2, r0, j * BKV + cq, m0, m1, l0, l1, corr0, corr1);
          wgmma_wait<0>();
          fence_regs<C::ACC>(o);
          fence_regs<32>(p);
          release(&v_empty[stage_of(it)], lane);
          to_p(s, p);
        }
        rescale<D>(o, corr0, corr1);
        mbar_wait(&v_full[stage_of(it)], phase_of(it));
        issue_pv<D>(o, p, v_ring + stage_of(it) * C::KV_BYTES);
        wgmma_wait<0>();
        fence_regs<C::ACC>(o);
        release(&v_empty[stage_of(it)], lane);
        ++it;
      }
      // ---- epilogue: the row sums live spread over a quad; divide, round,
      // stage in the store box's swizzled layout, store by TMA
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, x);
        l1 += __shfl_xor_sync(0xffffffffu, l1, x);
      }
      const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
      if (g.lse != nullptr && lane % 4 == 0) {
        // the natural log-sum-exp of the scaled scores: m is in the log2
        // domain, so sum_k exp(s_k) = 2^m * l
        float* lr = g.lse + static_cast<int64_t>(b * g.Hq + h) * g.Sq;
        if (r0 < g.Sq) lr[r0] = (m0 + log2f(fmaxf(l0, 1e-30f))) * LN2;
        if (r0 + 8 < g.Sq) lr[r0 + 8] = (m1 + log2f(fmaxf(l1, 1e-30f))) * LN2;
      }
      if (tw == 0) bulk_wait_read<0>();  // the last tile's store has left the buffer
      bar_sync(EPI + wg, 128);
#pragma unroll
      for (int i = 0; i < C::ACC; i += 2) {
        const int hh = (i >> 1) & 1, j = i >> 2;     // row half, 8-column group
        const int r = 16 * warp + lane / 4 + 8 * hh;  // row of the warpgroup's 64
        const int off = (j / 8) * C::O_BOX + r * 128 + (((j % 8) ^ (r % 8)) << 4) + cq * 2;
        const float inv = hh ? inv1 : inv0;
        *reinterpret_cast<uint32_t*>(so_wg + off) = pack_bf16x2(o[i] * inv, o[i + 1] * inv);
      }
      fence_proxy_async();
      bar_sync(EPI + wg, 128);
      if (tw == 0 && q0 + 64 * wg < g.Sq) {
#pragma unroll
        for (int c = 0; c < D / CHUNK; ++c)
          tma_store_4d(&to, so_wg + c * C::O_BOX, c * CHUNK, h, q0 + 64 * wg, b);
        bulk_commit();
      }
    }
    if (tw == 0) bulk_wait_read<0>();
  }
}

// ---- f32: 32 query rows by 16 keys per step; thread (row tid/4, quarter
// tid%4) scores 4 keys of its row and accumulates every 4th output column
constexpr int FQ = 32, FK = 16, FTHREADS = 128;

template <int D>
__global__ void __launch_bounds__(FTHREADS)
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
  for (int i = tid; i < FQ * D; i += FTHREADS) {
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
    for (int i = tid; i < FK * D; i += FTHREADS) {
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
    if (geo.lse != nullptr && qd == 0)
      geo.lse[static_cast<int64_t>(bh) * geo.Sq + row] = m + logf(lm);
  }
}

constexpr int MAX_DEVICES = 64;

// A 4-D bf16 map over [B, S, H, cols] (dims cols, H, S, B) with boxes of 64
// columns by `rows` rows of one head of one batch; a box past `cols` loads
// zeros and stores nothing there.
bool encode_bshd(CUtensorMap* map, const void* base, int B, int S, int H, int cols,
                 int64_t sb, int64_t sh, int64_t ss, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh * 2),
                                 static_cast<cuuint64_t>(ss * 2),
                                 static_cast<cuuint64_t>(sb * 2)};
  const cuuint32_t box[4] = {CHUNK, 1, static_cast<cuuint32_t>(rows), 1};
  return encode_bf16(map, 4, base, dims, strides, box);
}

// The shared-memory limit is raised, and the SM count read, once per device
// and instance before its first launch. The tensors hold `cols` <= D columns.
template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                        int Hkv, Geometry g, int cols, cudaStream_t st) {
  static bool sized[MAX_DEVICES] = {};
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!sized[dev]) {
    e = cudaFuncSetAttribute(flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Cfg<D>::SMEM);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    sized[dev] = true;
  }
  g.bh = B * g.Hq;
  g.m_tiles = (g.Sq + BQ - 1) / BQ;
  g.tiles = g.bh * g.m_tiles;
  CUtensorMap tq{}, tk{}, tv{}, to{};
  if (!encode_bshd(&tq, q, B, g.Sq, g.Hq, cols, g.qsb, g.qsh, g.qss, BQ) ||
      !encode_bshd(&to, o, B, g.Sq, g.Hq, cols, g.qsb, g.qsh, g.qss, 64))
    return cudaErrorInvalidValue;
  if (g.Sk > 0 && (!encode_bshd(&tk, k, B, g.Sk, Hkv, cols, g.ksb, g.ksh, g.kss, BKV) ||
                   !encode_bshd(&tv, v, B, g.Sk, Hkv, cols, g.ksb, g.ksh, g.kss, BKV)))
    return cudaErrorInvalidValue;
  const int lanes = g.tiles < sms[dev] ? g.tiles : sms[dev];
  flash_bf16_kernel<D><<<lanes, THREADS, Cfg<D>::SMEM, st>>>(tq, tk, tv, to, g);
  return cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hkv,
           const Geometry& geo, int dt, cudaStream_t s) {
  // bf16 at d 96 takes the D = 128 instance over 96-column maps
  if (dt == BF16)
    return static_cast<int>(launch_bf16<D == 96 ? 128 : D>(q, k, v, o, B, Hkv, geo, D, s));
  if (dt != F32) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(B * geo.Hq, (geo.Sq + FQ - 1) / FQ);
  flash_f32_kernel<D><<<grid, FTHREADS, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), geo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ep_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  int B, int Hq, int Hkv, int Sq, int Sk, int D,
                                  int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb,
                                  int64_t ksh, int64_t kss, float scale, int window,
                                  int causal, int dt, void* lse, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return static_cast<int>(cudaGetLastError());
  if (Hkv <= 0 || Hq % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry geo{Sq, Sk, Hq / Hkv, Hq, qsb, qsh, qss, ksb, ksh, kss, scale, window,
                     causal != 0, 0, 0, 0, static_cast<float*>(lse)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch<128>(q, k, v, o, B, Hkv, geo, dt, s);
  if (D == 96) return launch<96>(q, k, v, o, B, Hkv, geo, dt, s);
  if (D == 64) return launch<64>(q, k, v, o, B, Hkv, geo, dt, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
