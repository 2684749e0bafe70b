// paged_decode_attention: split-KV flash decoding over a paged KV pool, one
// query token per request.
//
// Replaces src/repro/kernels/decode_attention.py:112 paged_decode_attention
// (the Pallas pair _stage1_kernel and _stage2_kernel: a (request, split,
// page) grid whose page axis runs in order over VMEM scratch, fed by a
// scalar-prefetched page table).
//
// Bound by bytes: every live K/V row is read once, and a decode query does
// two multiply-adds per element it reads (about 0.4 ms of f32 work against a
// 2.6 ms byte bound at DBRX widths over 32k tokens). What the design does
// about each cost of a first, simpler kernel (one block per split and kv head
// waiting on each chunk's loads, K and V widened to f32 in shared memory,
// CUDA cores only: 3.7x to 6.5x its bound on an H100):
//
// - Loads issued ahead. A block owns one (request, split, kv head) and walks
//   its split's live tokens in tiles through a ring of up to 3 stages in
//   shared memory (as many as the table's width needs: one for a table of
//   one tile), filled two tiles ahead of the compute. A token's row sits
//   wherever its page put it (any page size, 12 included), so a tile is a
//   gather of rows and a tensor map, which would cost host time per call,
//   cannot describe it. The GQA path moves each 256-byte row with one bulk
//   copy on the TMA engine (cp.async.bulk, completing on the stage's
//   mbarrier): no tensor map and no per-thread tracking of 16-byte pieces,
//   which kept too few bytes in flight (4.2 ms at 32k with 16-byte cp.async,
//   3.0 ms with bulk copies, on an H100). The other path uses 16-byte cp.async.
// - The pool's own type in shared memory: tiles stay bf16 (f16, f32).
// - q and the sums in registers, every K/V element read once from shared
//   memory for all the query heads of its kv head. The GQA path (bf16 q and
//   pools, dk == dv in {64, 128}, G <= 16: DBRX) runs S = Q K^T on tensor
//   cores (mma.sync m16n8k16 with the heads as M, q's fragments held for the
//   whole walk) and P.V too, with P split into a bf16 high part and the bf16
//   rounding of the rest (two products into the f32 accumulator: hi + lo
//   holds P to about 2^-17 of itself, where bf16 P alone would cost about
//   4e-4 on the output). Each of its four warps runs its own online softmax
//   over 16 tokens of every 64-token tile; the warps' (m, l, O) are merged in
//   warp order at the end. The shared pool of absorbed MLA at DeepSeek-V3's
//   widths (bf16, Hkv 1, 128 heads, dk 576, dv 512) has a path of its own on
//   wgmma (paged_mla_kernel below: 64 heads a block, TMA page loads, a
//   producer warpgroup and two consumer warpgroups). Every other case (f32 or
//   f16 pools, other widths, more heads, the shared pool at other widths)
//   runs on CUDA cores in f32: tiles of 32 tokens, scores with lane = token
//   over every 4th group of 8 key columns per warp, P.V with a thread on 4
//   value columns of every head. f32 pools never go through TF32.
// - A partition that fits the work. How a request's live tokens are cut into
//   splits depends only on its own kv_len and the caller's split count (an
//   upper bound): n = min(S, max(1, kv_len / 256)) splits of a span rounded
//   up to whole tiles (split_span; kernels/decode_attention.py kv_splits
//   mirrors it). A request of one split (every request of a short-context
//   serve) writes its normalised output directly and no partials; stage 2
//   merges only the split ones, in split order, and is launched only when a
//   request of the table's width could be split. The grid's split axis is
//   the most splits the table allows.
//
// Tokens at or past kv_len are never read: their probabilities are an exact
// 0 (valid ? exp(s - m) : 0), and the GQA path zeroes the V rows of a tile
// past the end instead of reading them, so garbage in recycled or pad pages
// cannot change a bit. Idle rows (kv_len 0) write exactly 0. Every sum runs
// in a fixed order with no atomics, so two calls give the same bits and a
// request's result does not depend on its neighbours. In share_kv mode
// (absorbed MLA: Hkv == 1, values are the leading dv key columns) the value
// reads come from the key tile: the CUDA-core path reads the shared pool once
// per tile of 16 heads, the MLA path once per block of 64 heads, the second
// block of a pair from L2.
#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TT = 32;          // tokens per tile: one per lane in the score phase
constexpr int MIN_SPLIT = 256;  // fewest tokens of a split but the last
constexpr int MAXQ = 16;        // query heads per block
constexpr int SMEM_MAX = 232448;
static_assert(THREADS == 4 * TT, "four loader threads per token");

// Splits of one request and the span of each (a multiple of TT, at least
// MIN_SPLIT); split s covers tokens [s * span, min((s + 1) * span, kv_len)).
// An idle request has one empty split.
__host__ __device__ inline int split_span(int kv_len, int S, int* nsplit) {
  if (kv_len <= 0) {
    *nsplit = 1;
    return TT;
  }
  const int want = kv_len / MIN_SPLIT;
  const int n = want < 1 ? 1 : (S < want ? S : want);
  const int per = (kv_len + n - 1) / n;
  const int span = (per + TT - 1) / TT * TT;
  *nsplit = (kv_len + span - 1) / span;
  return span;
}

// The most splits a request of the table can have: the grid's split axis.
inline int most_splits(int S, int max_pages, int page) {
  int n;
  split_span(max_pages * page, S, &n);
  return n;
}

// Shared memory of stage 1, in bytes: the ring (reused at the end to merge the
// token groups' sums), q as f32, the warps' partial scores, P, and m, l and
// the tile's correction per head.
struct Layout {
  int kstride, vstride, stage, cg, tg;
  int64_t qs, sp, pt, ms, total;
};

__host__ __device__ inline Layout layout(int dk, int dv, int elt, int qt, int share_kv,
                                         int stages) {
  Layout L;
  const int krow = dk * elt;
  L.kstride = krow + (((16 - krow) % 128) + 128) % 128;   // == 16 mod 128: no bank conflict
  L.vstride = share_kv ? L.kstride : dv * elt;
  L.stage = TT * L.kstride + (share_kv ? 0 : TT * L.vstride);
  L.cg = dv / 4;
  L.tg = THREADS / L.cg < TT ? THREADS / L.cg : TT;
  const int64_t merge = static_cast<int64_t>(L.tg - 1) * qt * dv * 4;
  const int64_t ring = static_cast<int64_t>(stages) * L.stage;
  L.qs = ring > merge ? ring : merge;
  L.sp = L.qs + static_cast<int64_t>(qt) * dk * 4;
  L.pt = L.sp + static_cast<int64_t>(WARPS) * qt * TT * 4;
  L.ms = L.pt + static_cast<int64_t>(qt) * TT * 4;
  L.total = L.ms + 3 * qt * 4;
  return L;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One contiguous copy global -> shared by the TMA engine, completing `bytes`
// on the barrier.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// 8 (or 4) consecutive elements of a 16-byte (8-byte) aligned row in shared
// memory, widened to f32 exactly.
__device__ __forceinline__ void bf16x2(uint32_t u, float& lo, float& hi) {
  lo = __uint_as_float(u << 16);
  hi = __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ void smem8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  bf16x2(u.x, v[0], v[1]);
  bf16x2(u.y, v[2], v[3]);
  bf16x2(u.z, v[4], v[5]);
  bf16x2(u.w, v[6], v[7]);
}

__device__ __forceinline__ void smem8(const __half* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __half22float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void smem8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void smem4(const __nv_bfloat16* p, float v[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  bf16x2(u.x, v[0], v[1]);
  bf16x2(u.y, v[2], v[3]);
}

__device__ __forceinline__ void smem4(const __half* p, float v[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
  const float2 a = __half22float2(h[0]), b = __half22float2(h[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void smem4(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// ---- the GQA path on tensor cores: bf16 q and pools, dk == dv == D (64 or
// 128), at most 16 query heads per kv head, no shared pool. A block owns one
// (request, split, kv head) and all G heads (the 16 rows of an mma tile);
// tiles of FT tokens, 16 per warp. Each warp runs its own online softmax over
// its tokens: S = Q K^T with mma.sync m16n8k16 (heads as M, tokens as N; q's
// fragments in registers for the whole walk, K through ldmatrix), then P.V
// with P split into a bf16 high part and a bf16 low part (P - hi), two
// products into the f32 accumulator, V through ldmatrix.trans: the bf16
// products are exact and hi + lo holds P to about 2^-17 of itself. The
// warps' (m, l, O) are merged in warp order at the end. V rows past the
// split's end are zeroed in the tile (never read from the pool) so that their
// zero probabilities meet finite values.
constexpr int FT = 64;          // tokens per tile: 16 per warp

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// p0, p1 (f32) -> their bf16 high parts and the bf16 rounding of what is left
__device__ __forceinline__ void split_pair(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  hi = bf16_pair(p0, p1);
  float h0, h1;
  bf16x2(hi, h0, h1);
  lo = bf16_pair(p0 - h0, p1 - h1);
}

template <int D>
struct Fast {
  static constexpr int KSTR = D * 2 + (((16 - D * 2) % 128) + 128) % 128;  // row bytes
  static constexpr int STAGE = 2 * FT * KSTR;                              // K and V tiles
  static constexpr int MERGE = (2 * WARPS * 16 + WARPS * 16 * D) * 4;
  __host__ __device__ static int64_t smem(int stages) {
    const int64_t ring = static_cast<int64_t>(stages) * STAGE;
    return ring > MERGE ? ring : MERGE;
  }
};

template <int D>
__global__ void __launch_bounds__(THREADS, 4) paged_gqa_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, const int* __restrict__ tbl,
    const int* __restrict__ lens, float* __restrict__ out, float* __restrict__ o,
    float* __restrict__ lse, int Hq, int Hkv, int page, int max_pages, int S, int stages,
    float scale) {
  using F = Fast<D>;
  constexpr int KS = D / 16, NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int* tbl_row = tbl + b * max_pages;
  const int t = threadIdx.x % FT;
  // split 0's first page ids, read beside kv_len rather than after it
  const int first = __ldg(tbl_row + min(t / page, max_pages - 1));
  const int kv_len = min(lens[b], max_pages * page);
  int nsplit;
  const int span = split_span(kv_len, S, &nsplit);
  if (s >= nsplit) return;
  const int kvh = blockIdx.x;
  const int G = Hq / Hkv, h0 = kvh * G;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int start = s * span;
  const int end = min(start + span, kv_len);
  const int nt = (max(end - start, 0) + FT - 1) / FT;

  // one thread per row: threads 0..63 the K rows of the tile's tokens,
  // 64..127 the V rows, each one bulk copy (the TMA engine; no tensor map)
  // completing on the stage's barrier, which every thread arrives at once
  // per tile with the bytes it asked for. A V row past the end is zeroed
  // instead. A thread's page id for a tile is read one tile ahead (page_of),
  // so the table's latency hides behind the compute of the tile before.
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + F::smem(stages));
  const bool vrow = tid >= FT;
  auto page_of = [&](int i) {
    const int pos = start + i * FT + t;
    return pos < end ? __ldg(tbl_row + pos / page) : 0;
  };
  auto load_tile = [&](int i, int pid) {
    const int pos = start + i * FT + t;
    unsigned char* dst = smem + (i % stages) * F::STAGE + ((vrow ? FT : 0) + t) * F::KSTR;
    uint64_t* bar = full + i % stages;
    if (pos < end) {
      const int64_t row = (static_cast<int64_t>(pid) * page + pos % page) * Hkv + kvh;
      const __nv_bfloat16* src = (vrow ? vp : kp) + row * D;
      mbar_expect_tx(bar, D * 2);
      fence_proxy_async();
      bulk_load(dst, src, D * 2, bar);
    } else {
      if (vrow)
#pragma unroll
        for (int c = 0; c < D * 2; c += 16)
          *reinterpret_cast<uint4*>(dst + c) = make_uint4(0u, 0u, 0u, 0u);
      mbar_arrive(bar);
    }
  };

  if (tid == 0) {
    for (int k = 0; k < stages; ++k) mbar_init(full + k, THREADS);
    mbar_init_fence();
  }
  __syncthreads();
  int pid = s == 0 ? first : page_of(0);
  for (int k = 0; k < stages - 1; ++k) {
    if (k < nt) load_tile(k, pid);
    pid = page_of(k + 1);
  }

  // q's A fragments (rows: heads gid and gid + 8; zero past G), once
  uint32_t qa[KS][4];
  {
    const uint32_t* ra = reinterpret_cast<const uint32_t*>(q + (b * Hq + h0 + gid) * D);
    const uint32_t* rb = reinterpret_cast<const uint32_t*>(q + (b * Hq + h0 + gid + 8) * D);
    const bool va = gid < G, vb = gid + 8 < G;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qa[kk][0] = va ? ra[kk * 8 + tig] : 0u;
      qa[kk][1] = vb ? rb[kk * 8 + tig] : 0u;
      qa[kk][2] = va ? ra[kk * 8 + 4 + tig] : 0u;
      qa[kk][3] = vb ? rb[kk * 8 + 4 + tig] : 0u;
    }
  }
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int c = 0; c < NT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  const int mtx = lane / 8, mrow = lane % 8;

  for (int i = 0; i < nt; ++i) {
    if (stages == 1) {
      __syncthreads();                  // the last tile's readers are done
      load_tile(i, pid);
      pid = page_of(i + 1);
    }
    mbar_wait(full + i % stages, (i / stages) & 1);
    __syncthreads();                    // tile i - 1's readers are done; zeroed rows seen
    if (stages > 1) {
      if (i + stages - 1 < nt) load_tile(i + stages - 1, pid);
      pid = page_of(i + stages);
    }
    const unsigned char* st = smem + (i % stages) * F::STAGE;
    const int tok0 = warp * 16;
    const int base = start + i * FT + tok0;

    // S [heads, 16 tokens]: two n-tiles of 8 tokens
    float sc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t kb[4];
      ldsm_x4(kb, st + (tok0 + (mtx >> 1) * 8 + mrow) * F::KSTR + (kk * 16 + (mtx & 1) * 8) * 2);
      mma_bf16(sc[0], qa[kk], kb[0], kb[1]);
      mma_bf16(sc[1], qa[kk], kb[2], kb[3]);
    }

    // online softmax of this warp's tokens: element e of n-tile j is head
    // gid + 8 * (e / 2), token j * 8 + 2 * tig + e % 2; masked tokens an
    // exact 0; row reductions over the four lanes of a row, fixed butterflies
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = base + j * 8 + 2 * tig + (e & 1) < end;
        sc[j][e] = valid ? sc[j][e] * scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = base + j * 8 + 2 * tig + (e & 1) < end;
        sc[j][e] = valid ? expf(sc[j][e] - m[e >> 1]) : 0.f;
        psum[e >> 1] += sc[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l[r] = l[r] * corr[r] + psum[r];
    }
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      acc[c][0] *= corr[0];
      acc[c][1] *= corr[0];
      acc[c][2] *= corr[1];
      acc[c][3] *= corr[1];
    }

    // O += P V: P's A fragment is S's C fragments side by side
    uint32_t ph[4], pl[4];
    split_pair(sc[0][0], sc[0][1], ph[0], pl[0]);
    split_pair(sc[0][2], sc[0][3], ph[1], pl[1]);
    split_pair(sc[1][0], sc[1][1], ph[2], pl[2]);
    split_pair(sc[1][2], sc[1][3], ph[3], pl[3]);
    const unsigned char* vb = st + FT * F::KSTR;
#pragma unroll
    for (int c = 0; c < NT; c += 2) {
      uint32_t vf[4];
      ldsm_x4_trans(vf, vb + (tok0 + (mtx & 1) * 8 + mrow) * F::KSTR + (c + (mtx >> 1)) * 16);
      mma_bf16(acc[c], ph, vf[0], vf[1]);
      mma_bf16(acc[c], pl, vf[0], vf[1]);
      mma_bf16(acc[c + 1], ph, vf[2], vf[3]);
      mma_bf16(acc[c + 1], pl, vf[2], vf[3]);
    }
  }
  __syncthreads();                      // the ring is free: merge the warps there

  float* mw = reinterpret_cast<float*>(smem);      // [WARPS][16] running max
  float* lw = mw + WARPS * 16;                     // [WARPS][16] running sum
  float* ow = lw + WARPS * 16;                     // [WARPS][16][D] unnormalised O
  if (tig == 0) {
    mw[warp * 16 + gid] = m[0];
    mw[warp * 16 + gid + 8] = m[1];
    lw[warp * 16 + gid] = l[0];
    lw[warp * 16 + gid + 8] = l[1];
  }
#pragma unroll
  for (int c = 0; c < NT; ++c) {
    *reinterpret_cast<float2*>(ow + (warp * 16 + gid) * D + c * 8 + 2 * tig) =
        make_float2(acc[c][0], acc[c][1]);
    *reinterpret_cast<float2*>(ow + (warp * 16 + gid + 8) * D + c * 8 + 2 * tig) =
        make_float2(acc[c][2], acc[c][3]);
  }
  __syncthreads();
  float* dst = nsplit == 1 ? out + (b * Hq + h0) * D : o + ((b * S + s) * Hq + h0) * D;
  for (int i = tid; i < G * (D / 4); i += THREADS) {
    const int h = i / (D / 4), col = (i % (D / 4)) * 4;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      if (lw[w * 16 + h] > 0.f) M = fmaxf(M, mw[w * 16 + h]);
    float L = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float lv = lw[w * 16 + h];
      const float wt = lv > 0.f ? expf(mw[w * 16 + h] - M) : 0.f;
      const float4 v = *reinterpret_cast<const float4*>(ow + (w * 16 + h) * D + col);
      L += wt * lv;
      a.x += wt * v.x; a.y += wt * v.y; a.z += wt * v.z; a.w += wt * v.w;
    }
    float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
    if (L > 0.f) r = make_float4(a.x / L, a.y / L, a.z / L, a.w / L);
    *reinterpret_cast<float4*>(dst + h * D + col) = r;
    if (nsplit > 1 && col == 0)
      lse[(b * S + s) * Hq + h0 + h] = L > 0.f ? M + logf(L) : NEG_INF;
  }
}

// ---- the shared-pool path on tensor cores (absorbed MLA at DeepSeek-V3's
// widths): bf16 q and pool, Hkv 1, rows of [ckv 512 | k_rope 64] (dk 576)
// whose leading 512 columns are the values (dv 512), query heads in blocks of
// 64, pages of 8, 16 or 32 tokens.
//
// - A block owns 64 query heads (wgmma's M) of one (request, split); the
//   head blocks are the grid's fastest axis, so the two of DeepSeek-V3's 128
//   heads run side by side and the second read of every K tile comes from L2:
//   the pool is read from device memory about once. 64 heads is as wide as a
//   block can hold: O for 64 heads x 512 columns in f32 is 128 KB of
//   registers, half the SM's file; 128 heads would need all of it.
// - Warp-specialised: one thread of a producer warpgroup issues every TMA
//   load; two consumer warpgroups each own 256 of the 512 value columns (128
//   f32 accumulators a thread). ptxas gives a block of 384 threads 168
//   registers a thread; setmaxnreg moves the producer to 40 and the
//   consumers to 232.
// - Shared memory: q's 64 heads (72 KB, loaded once) and a ring of two K
//   tiles of 64 tokens (72 KB each), each as nine 128-byte swizzled slabs of
//   64 columns that a wgmma descriptor reads. A page is one TMA box per slab
//   (3-D maps over the pool [pages, page, 576] and over q [B, Hq, 576],
//   encoded on the host per call); a tile is 64 / page whole pages, since a
//   split starts at a multiple of 32 tokens. Pages of a tile past the split's
//   end are not loaded.
// - S = Q K^T: wgmma m64n64k16, both operands K-major in shared memory, 36
//   steps over 576. Each consumer warpgroup computes S itself (the same 64
//   heads: 36% more tensor work than sharing P through shared memory, which
//   would not fit beside q and two stages of 64 tokens).
// - Ping-pong: named barriers hand the tensor cores from one warpgroup to
//   the other at each batch of products (S, then P V), so one warpgroup's
//   softmax runs under the other's products.
// - Softmax in f32 registers, in the log2 domain with the scale folded into
//   one multiply: a position at or past the split's end gets p = exactly 0
//   (a select), p = 2^(s - m) (a one-token request gets p = 1 and its value
//   row exactly); the accumulators are rescaled only where the running max
//   moved (a factor of exactly 1 elsewhere).
// - O += P V: P from registers as a bf16 high part and the bf16 rounding of
//   the rest (two products, as the GQA path), V the leading 512 columns of
//   the same K tile read MN-major (transpose-B), no second load. In the last
//   tile of a split each warpgroup zeroes its value columns of the rows past
//   the end first, so that 0 x recycled-page garbage stays 0.
struct Mla {
  static constexpr int DK = 576, DV = 512;
  static constexpr int HEADS = 64;                     // query heads a block
  static constexpr int TILE = 64;                      // tokens a K tile
  static constexpr int CH = 64;                        // columns a swizzled slab
  static constexpr int NCH = DK / CH;                  // 9 slabs a row
  static constexpr int SLAB = TILE * CH * 2;           // 8 KB: 64 rows of 128 bytes
  static constexpr int TILE_BYTES = NCH * SLAB;        // 72 KB (q's 64 heads alike)
  static constexpr int STAGES = 2;
  static constexpr int VSLABS = DV / CH / 2;           // value slabs a warpgroup: 4
  static constexpr int CONSUMERS = 256, THREADS = CONSUMERS + 128;
  static constexpr int SCHED = 1;                      // named barrier SCHED + w: w's turn
  static constexpr int ZERO = 3;                       // named barrier ZERO + w: w's zeroed rows
  static constexpr int SMEM = 1024 + (1 + STAGES) * TILE_BYTES + (1 + 2 * STAGES) * 8;
  static_assert(SMEM <= SMEM_MAX, "q and two stages must fit");
};

// Online softmax over one S tile of `n` live tokens in the log2 domain:
// register e holds head r + 8 * ((e / 2) % 2), token 8 * (e / 4) + 2 * t4 +
// e % 2; a quad of lanes shares a head. Leaves p in sc and each head's
// correction of its old max in c0, c1.
template <bool MASK>
__device__ __forceinline__ void mla_softmax(float* sc, int n, int t4, float sl2, float& m0,
                                            float& m1, float& l0, float& l1, float& c0,
                                            float& c1) {
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    if constexpr (MASK)
      sc[e] = 8 * (e >> 2) + 2 * t4 + (e & 1) < n ? sc[e] * sl2 : NEG_INF;
    else
      sc[e] *= sl2;
    if ((e >> 1) & 1) mx1 = fmaxf(mx1, sc[e]);
    else mx0 = fmaxf(mx0, sc[e]);
  }
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
  }
  const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
  c0 = ex2(m0 - n0);
  c1 = ex2(m1 - n1);
  m0 = n0;
  m1 = n1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const bool hi = (e >> 1) & 1;
    const float p = ex2(sc[e] - (hi ? n1 : n0));
    sc[e] = MASK && 8 * (e >> 2) + 2 * t4 + (e & 1) >= n ? 0.f : p;
    if (hi) ps1 += sc[e];
    else ps0 += sc[e];
  }
  l0 = l0 * c0 + ps0;
  l1 = l1 * c1 + ps1;
}

__global__ void __launch_bounds__(Mla::THREADS, 1) paged_mla_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const int* __restrict__ tbl, const int* __restrict__ lens, float* __restrict__ out,
    float* __restrict__ o, float* __restrict__ lse, int Hq, int page, int max_pages, int S,
    float scale) {
  using M = Mla;
  extern __shared__ uint8_t smem_raw[];
  const int s = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int kv_len = min(lens[b], max_pages * page);
  int nsplit;
  const int span = split_span(kv_len, S, &nsplit);
  if (s >= nsplit) return;
  const int h0 = blockIdx.x * M::HEADS;
  const int start = s * span;
  const int end = min(start + span, kv_len);
  const int nt = (max(end - start, 0) + M::TILE - 1) / M::TILE;
  // the 128-byte swizzle repeats every 1024 bytes: align the buffers to it
  uint8_t* sq = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* ring = sq + M::TILE_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + M::STAGES * M::TILE_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + M::STAGES;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);                       // the producer's expect_tx
    for (int i = 0; i < M::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], M::CONSUMERS / 32);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  // warp-uniform by construction, so that wgmma never sits on a path the
  // compiler must treat as divergent
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (wg == 2) {  // ---- producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != M::CONSUMERS || nt == 0) return;
    const int* tbl_row = tbl + b * max_pages;
    mbar_expect_tx(q_full, M::TILE_BYTES);
    for (int c = 0; c < M::NCH; ++c)
      tma_load_3d(sq + c * M::SLAB, &tq, q_full, c * M::CH, h0, static_cast<int>(b));
    for (int i = 0; i < nt; ++i) {
      const int st = i % M::STAGES;
      const int t0 = start + i * M::TILE;
      const int np = (min(M::TILE, end - t0) + page - 1) / page;   // pages with a live token
      int pid[M::TILE / 8];
#pragma unroll
      for (int j = 0; j < M::TILE / 8; ++j)     // read before the wait
        pid[j] = j < np ? __ldg(tbl_row + t0 / page + j) : 0;
      mbar_wait(&empty[st], ((i / M::STAGES) & 1) ^ 1);
      mbar_expect_tx(&full[st], np * page * M::DK * 2);
      uint8_t* dst = ring + st * M::TILE_BYTES;
#pragma unroll
      for (int j = 0; j < M::TILE / 8; ++j)
        if (j < np)
#pragma unroll
          for (int c = 0; c < M::NCH; ++c)
            tma_load_3d(dst + c * M::SLAB + j * page * 128, &tk, &full[st], c * M::CH, 0,
                        pid[j]);
    }
    return;
  }

  // ---- consumers: warpgroup wg owns value columns [256 wg, 256 wg + 256)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32, t4 = lane % 4;
  const uint32_t q_s = smem_u32(sq), ring_s = smem_u32(ring);
  const float sl2 = scale * LOG2E;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // heads r, r + 8 of this thread
  if (nt > 0) mbar_wait(q_full, 0);
  if (wg == 1) bar_arrive(M::SCHED + 0, M::CONSUMERS);   // warpgroup 0 issues first
  for (int i = 0; i < nt; ++i) {
    const int st = i % M::STAGES;
    const uint32_t k_s = ring_s + st * M::TILE_BYTES;
    const int n = min(M::TILE, end - (start + i * M::TILE));   // live tokens of the tile
    mbar_wait(&full[st], (i / M::STAGES) & 1);

    // S [64 heads, 64 tokens]: 16 columns a step are 32 bytes along the
    // swizzled row, slabs SLAB apart, 8-row groups 1024 bytes apart
    float sc[32];
    bar_sync(M::SCHED + wg, M::CONSUMERS);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < M::DK / 16; ++kk) {
      const uint32_t off = (kk / 4) * M::SLAB + (kk % 4) * 32;
      wgmma_ss_n64<0>(sc, sw128_desc(q_s + off, 16, 1024), sw128_desc(k_s + off, 16, 1024),
                      kk > 0);
    }
    wgmma_commit();
    bar_arrive(M::SCHED + 1 - wg, M::CONSUMERS);
    wgmma_wait<0>();
    fence_regs<32>(sc);

    float c0, c1;
    if (n == M::TILE) mla_softmax<false>(sc, n, t4, sl2, m0, m1, l0, l1, c0, c1);
    else mla_softmax<true>(sc, n, t4, sl2, m0, m1, l0, l1, c0, c1);
    if (c0 != 1.f || c1 != 1.f)
#pragma unroll
      for (int e = 0; e < 128; ++e) acc[e] *= ((e >> 1) & 1) ? c1 : c0;
    uint32_t ph[16], pl[16];   // P's A fragments: registers 4kk..4kk+3 cover tokens 16kk..
#pragma unroll
    for (int j = 0; j < 16; ++j) split_pair(sc[2 * j], sc[2 * j + 1], ph[j], pl[j]);

    if (n < M::TILE) {   // the split's last tile: zero this warpgroup's value rows past the end
      uint8_t* stage = ring + st * M::TILE_BYTES;
      for (int x = tw; x < (M::TILE - n) * M::VSLABS * 8; x += 128) {
        const int r = n + x / (M::VSLABS * 8), c = (x / 8) % M::VSLABS, piece = x % 8;
        *reinterpret_cast<uint4*>(stage + (M::VSLABS * wg + c) * M::SLAB + r * 128 + piece * 16) =
            make_uint4(0u, 0u, 0u, 0u);
      }
      fence_proxy_async();
      bar_sync(M::ZERO + wg, 128);
    }

    // O += P V: value slabs 4 wg .. 4 wg + 3 of the tile, MN-major; 16
    // tokens a step are 16 rows of 128 bytes; two n128 products a step
    bar_sync(M::SCHED + wg, M::CONSUMERS);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < M::TILE / 16; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint64_t db = sw128_desc(k_s + (M::VSLABS * wg + 2 * half) * M::SLAB + kk * 16 * 128,
                                       M::SLAB, 1024);
        wgmma_rs_n128(acc + 64 * half, ph + 4 * kk, db, 1);
        wgmma_rs_n128(acc + 64 * half, pl + 4 * kk, db, 1);
      }
    wgmma_commit();
    bar_arrive(M::SCHED + 1 - wg, M::CONSUMERS);
    wgmma_wait<0>();
    fence_regs<128>(acc);
    fence_regs<16>(ph);
    fence_regs<16>(pl);
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // ---- epilogue: the row sums live spread over a quad; O / l in f32
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const int r = 16 * warp + lane / 4;
  float* dst = (nsplit == 1 ? out + (b * Hq + h0) * M::DV
                            : o + ((b * S + s) * Hq + h0) * M::DV) + 256 * wg + 2 * t4;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float2 va = l0 > 0.f ? make_float2(acc[4 * j] / l0, acc[4 * j + 1] / l0)
                               : make_float2(0.f, 0.f);
    const float2 vb = l1 > 0.f ? make_float2(acc[4 * j + 2] / l1, acc[4 * j + 3] / l1)
                               : make_float2(0.f, 0.f);
    *reinterpret_cast<float2*>(dst + r * M::DV + 8 * j) = va;
    *reinterpret_cast<float2*>(dst + (r + 8) * M::DV + 8 * j) = vb;
  }
  if (nsplit > 1 && wg == 0 && t4 == 0) {   // natural log: m is in the log2 domain
    float* lrow = lse + (b * S + s) * Hq + h0;
    lrow[r] = l0 > 0.f ? m0 / LOG2E + logf(l0) : NEG_INF;
    lrow[r + 8] = l1 > 0.f ? m1 / LOG2E + logf(l1) : NEG_INF;
  }
}

// ---- every other case on CUDA cores.
// MQ: the most query heads a block holds (registers scale with it): 8 serves
// GQA up to 8 heads per kv head, 16 the rest.
template <typename KT, int MQ>
__global__ void __launch_bounds__(THREADS) paged_stage1_kernel(
    const void* __restrict__ q, const KT* __restrict__ kp, const KT* __restrict__ vp,
    const int* __restrict__ tbl, const int* __restrict__ lens, float* __restrict__ out,
    float* __restrict__ o, float* __restrict__ lse, int Hq, int Hkv, int dk, int dv,
    int page, int max_pages, int S, int qt, int ntiles, int stages, float scale, int qdt,
    int share_kv) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int kv_len = min(lens[b], max_pages * page);   // the table's tokens only
  int nsplit;
  const int span = split_span(kv_len, S, &nsplit);
  if (s >= nsplit) return;
  const int kvh = blockIdx.x / ntiles, tile = blockIdx.x % ntiles;
  const int G = Hq / Hkv;
  const int h0 = kvh * G + tile * qt;
  const int nq = min(qt, G - tile * qt);
  const Layout L = layout(dk, dv, sizeof(KT), qt, share_kv, stages);
  float* qs = reinterpret_cast<float*>(smem + L.qs);   // [qt][dk]
  float* sp = reinterpret_cast<float*>(smem + L.sp);   // [WARPS][qt][TT] partial scores
  float* pt = reinterpret_cast<float*>(smem + L.pt);   // [qt][TT] probabilities
  float* ms = reinterpret_cast<float*>(smem + L.ms);   // [qt] running max
  float* ls = ms + qt;                                 // [qt] running sum
  float* cs = ls + qt;                                 // [qt] this tile's correction
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  const int64_t qsz = dtype_size(qdt);
  for (int i = tid; i < nq * (dk / 8); i += THREADS) {
    const int qh = i / (dk / 8), c = (i % (dk / 8)) * 8;
    float v[8];
    load8(static_cast<const char*>(q) + ((b * Hq + h0 + qh) * dk) * qsz, c, qdt, v);
    float4* d = reinterpret_cast<float4*>(qs + qh * dk + c);
    d[0] = make_float4(v[0], v[1], v[2], v[3]);
    d[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
  if (tid < qt) {
    ms[tid] = NEG_INF;
    ls[tid] = 0.f;
  }

  const int start = s * span;
  const int end = min(start + span, kv_len);
  const int ntok = max(end - start, 0);
  const int nt = (ntok + TT - 1) / TT;
  const int* tbl_row = tbl + b * max_pages;
  const int krow = dk * static_cast<int>(sizeof(KT)), vrow = dv * static_cast<int>(sizeof(KT));

  // four threads per token: each copies every 4th 16-byte piece of its K and
  // V rows; rows at or past the split's end are not read
  auto load_tile = [&](int i) {
    const int t = tid / 4, sub = tid % 4;
    const int pos = start + i * TT + t;
    if (pos < end) {
      const int j = pos / page;
      const int64_t row =
          (static_cast<int64_t>(__ldg(tbl_row + j)) * page + (pos - j * page)) * Hkv + kvh;
      unsigned char* st = smem + (i % stages) * L.stage;
      const char* ks = reinterpret_cast<const char*>(kp) + row * krow;
      for (int c = sub * 16; c < krow; c += 64) cp_async16(st + t * L.kstride + c, ks + c);
      if (!share_kv) {
        const char* vs = reinterpret_cast<const char*>(vp) + row * vrow;
        unsigned char* vd = st + TT * L.kstride + t * L.vstride;
        for (int c = sub * 16; c < vrow; c += 64) cp_async16(vd + c, vs + c);
      }
    }
  };

  for (int k = 0; k < stages - 1; ++k) {
    if (k < nt) load_tile(k);
    cp_async_commit();
  }

  const int cg = tid % L.cg, tg = tid / L.cg;
  const bool pv = tg < L.tg;
  const int col = cg * 4;
  float acc[MQ][4];
#pragma unroll
  for (int h = 0; h < MQ; ++h)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[h][k] = 0.f;

  for (int i = 0; i < nt; ++i) {
    if (stages >= 3) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();                    // tile i landed; tile i - 1's readers are done
    if (i + stages - 1 < nt) load_tile(i + stages - 1);
    cp_async_commit();
    const unsigned char* st = smem + (i % stages) * L.stage;
    const int n = min(TT, end - (start + i * TT));

    // scores: lane = token, this warp's groups of 8 key columns, all heads
    float part[MQ];
#pragma unroll
    for (int h = 0; h < MQ; ++h) part[h] = 0.f;
    const unsigned char* kr = st + lane * L.kstride;
    for (int c = warp * 8; c < dk; c += 8 * WARPS) {
      float kv[8];
      smem8(reinterpret_cast<const KT*>(kr) + c, kv);
#pragma unroll
      for (int h = 0; h < MQ; ++h) {
        if (h < nq) {
          const float4 a = *reinterpret_cast<const float4*>(qs + h * dk + c);
          const float4 e = *reinterpret_cast<const float4*>(qs + h * dk + c + 4);
          part[h] += a.x * kv[0] + a.y * kv[1] + a.z * kv[2] + a.w * kv[3] +
                     e.x * kv[4] + e.y * kv[5] + e.z * kv[6] + e.w * kv[7];
        }
      }
    }
#pragma unroll
    for (int h = 0; h < MQ; ++h)
      if (h < nq) sp[(warp * qt + h) * TT + lane] = part[h];
    __syncthreads();

    // online softmax: warp w takes heads w, w + 4, ...; lane = token; the
    // warps' partials summed in order, fixed butterflies, masked lanes an
    // exact 0
    for (int h = warp; h < nq; h += WARPS) {
      float sc = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sc += sp[(w * qt + h) * TT + lane];
      const bool valid = lane < n;
      sc = valid ? sc * scale : NEG_INF;
      float mx = sc;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = ms[h];
      const float m_new = fmaxf(m_prev, mx);
      const float p = valid ? expf(sc - m_new) : 0.f;
      float psum = p;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      pt[h * TT + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        ls[h] = ls[h] * corr + psum;
        ms[h] = m_new;
        cs[h] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + sum over this thread's live tokens of p * v, f32
    if (pv) {
#pragma unroll
      for (int h = 0; h < MQ; ++h) {
        if (h < nq) {
          const float c = cs[h];
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[h][k] *= c;
        }
      }
      const unsigned char* vb = share_kv ? st : st + TT * L.kstride;
      for (int t = tg; t < n; t += L.tg) {
        float v[4];
        smem4(reinterpret_cast<const KT*>(vb + t * L.vstride) + col, v);
#pragma unroll
        for (int h = 0; h < MQ; ++h) {
          if (h < nq) {
            const float p = pt[h * TT + t];
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[h][k] += p * v[k];
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                      // the ring is free: merge the token groups there

  float* mrg = reinterpret_cast<float*>(smem);      // [tg - 1][qt][dv]
  if (pv && tg > 0) {
#pragma unroll
    for (int h = 0; h < MQ; ++h)
      if (h < nq)
        *reinterpret_cast<float4*>(mrg + ((tg - 1) * qt + h) * dv + col) =
            make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
  }
  __syncthreads();
  if (pv && tg == 0) {
    for (int g = 1; g < L.tg; ++g) {
#pragma unroll
      for (int h = 0; h < MQ; ++h) {
        if (h < nq) {
          const float4 a = *reinterpret_cast<const float4*>(mrg + ((g - 1) * qt + h) * dv + col);
          acc[h][0] += a.x; acc[h][1] += a.y; acc[h][2] += a.z; acc[h][3] += a.w;
        }
      }
    }
    float* dst = nsplit == 1 ? out + (b * Hq + h0) * dv
                             : o + ((b * S + s) * Hq + h0) * dv;
#pragma unroll
    for (int h = 0; h < MQ; ++h) {
      if (h < nq) {
        const float l = ls[h];
        float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
        if (l > 0.f) r = make_float4(acc[h][0] / l, acc[h][1] / l, acc[h][2] / l, acc[h][3] / l);
        *reinterpret_cast<float4*>(dst + h * dv + col) = r;
      }
    }
  }
  if (nsplit > 1 && tid < nq) {
    const float l = ls[tid];
    lse[(b * S + s) * Hq + h0 + tid] = l > 0.f ? ms[tid] + logf(l) : NEG_INF;
  }
}

constexpr int HPB = 4;          // heads per stage-2 block

// The requests cut into more than one split: their splits' outputs weighed
// by exp(lse - max) in split order; an empty split has exactly zero weight.
__global__ void __launch_bounds__(THREADS) paged_stage2_kernel(
    const float* __restrict__ o, const float* __restrict__ lse, const int* __restrict__ lens,
    float* __restrict__ out, int S, int Hq, int dv, int max_tokens) {
  const int64_t b = blockIdx.y;
  int nsplit;
  split_span(min(lens[b], max_tokens), S, &nsplit);
  if (nsplit <= 1) return;
  const int c4 = dv / 4;
  for (int i = threadIdx.x; i < HPB * c4; i += THREADS) {
    const int h = blockIdx.x * HPB + i / c4, col = (i % c4) * 4;
    if (h >= Hq) break;
    const float* lrow = lse + b * S * Hq + h;       // stride Hq over the splits
    float mx = lrow[0];
    for (int s = 1; s < nsplit; ++s) mx = fmaxf(mx, lrow[static_cast<int64_t>(s) * Hq]);
    float denom = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < nsplit; ++s) {
      const float l = lrow[static_cast<int64_t>(s) * Hq];
      const float w = l > NEG_INF / 2 ? expf(l - mx) : 0.f;
      denom += w;
      const float4 v = *reinterpret_cast<const float4*>(o + ((b * S + s) * Hq + h) * dv + col);
      acc.x += w * v.x; acc.y += w * v.y; acc.z += w * v.z; acc.w += w * v.w;
    }
    float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
    if (denom > 0.f) r = make_float4(acc.x / denom, acc.y / denom, acc.z / denom, acc.w / denom);
    *reinterpret_cast<float4*>(out + (b * Hq + h) * dv + col) = r;
  }
}

constexpr int MAX_DEVICES = 64;

template <typename KT, int MQ>
int launch_stage1(const void* q, const void* kp, const void* vp, const void* tbl,
                  const void* lens, void* out, void* o, void* lse, int B, int S, int Hq,
                  int Hkv, int dk, int dv, int page, int max_pages, int qt, int ntiles,
                  int stages, float scale, int qdt, int share_kv, int64_t smem,
                  cudaStream_t stream) {
  // the shared-memory limit is raised once per device, outside any capture
  static bool raised[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(paged_stage1_kernel<KT, MQ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    raised[dev] = true;
  }
  dim3 grid(Hkv * ntiles, most_splits(S, max_pages, page), B);
  paged_stage1_kernel<KT, MQ><<<grid, THREADS, smem, stream>>>(
      q, static_cast<const KT*>(kp), static_cast<const KT*>(vp),
      static_cast<const int*>(tbl), static_cast<const int*>(lens),
      static_cast<float*>(out), static_cast<float*>(o), static_cast<float*>(lse), Hq, Hkv,
      dk, dv, page, max_pages, S, qt, ntiles, stages, scale, qdt, share_kv);
  return static_cast<int>(cudaGetLastError());
}

template <typename KT>
int dispatch_mq(const void* q, const void* kp, const void* vp, const void* tbl,
                const void* lens, void* out, void* o, void* lse, int B, int S, int Hq,
                int Hkv, int dk, int dv, int page, int max_pages, int qt, int ntiles,
                int stages, float scale, int qdt, int share_kv, int64_t smem,
                cudaStream_t st) {
  if (qt <= 8)
    return launch_stage1<KT, 8>(q, kp, vp, tbl, lens, out, o, lse, B, S, Hq, Hkv, dk, dv,
                                page, max_pages, qt, ntiles, stages, scale, qdt, share_kv,
                                smem, st);
  return launch_stage1<KT, MAXQ>(q, kp, vp, tbl, lens, out, o, lse, B, S, Hq, Hkv, dk, dv,
                                 page, max_pages, qt, ntiles, stages, scale, qdt, share_kv,
                                 smem, st);
}

template <int D>
int launch_fast(const void* q, const void* kp, const void* vp, const void* tbl,
                const void* lens, void* out, void* o, void* lse, int B, int S, int Hq, int Hkv,
                int page, int max_pages, int stages, float scale, cudaStream_t stream) {
  static bool raised[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(paged_gqa_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    raised[dev] = true;
  }
  dim3 grid(Hkv, most_splits(S, max_pages, page), B);
  paged_gqa_kernel<D><<<grid, THREADS, Fast<D>::smem(stages) + 8 * stages, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), static_cast<const int*>(tbl),
      static_cast<const int*>(lens), static_cast<float*>(out), static_cast<float*>(o),
      static_cast<float*>(lse), Hq, Hkv, page, max_pages, S, stages, scale);
  return static_cast<int>(cudaGetLastError());
}

// q viewed as [B, Hq, 576] and the pool as [pages, page, 576], boxes of 64
// columns by 64 heads or one page.
int launch_mla(const void* q, const void* kp, const void* tbl, const void* lens, void* out,
               void* o, void* lse, int B, int S, int Hq, int page, int max_pages,
               int pool_pages, float scale, cudaStream_t stream) {
  static bool raised[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(paged_mla_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Mla::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    raised[dev] = true;
  }
  constexpr cuuint64_t row = Mla::DK * 2;
  const cuuint64_t qdims[3] = {Mla::DK, static_cast<cuuint64_t>(Hq), static_cast<cuuint64_t>(B)};
  const cuuint64_t qstrides[2] = {row, row * Hq};
  const cuuint32_t qbox[3] = {Mla::CH, Mla::HEADS, 1};
  const cuuint64_t kdims[3] = {Mla::DK, static_cast<cuuint64_t>(page),
                               static_cast<cuuint64_t>(pool_pages)};
  const cuuint64_t kstrides[2] = {row, row * page};
  const cuuint32_t kbox[3] = {Mla::CH, static_cast<cuuint32_t>(page), 1};
  CUtensorMap tq{}, tk{};
  if (!encode_bf16(&tq, 3, q, qdims, qstrides, qbox) ||
      !encode_bf16(&tk, 3, kp, kdims, kstrides, kbox))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(Hq / Mla::HEADS, most_splits(S, max_pages, page), B);
  paged_mla_kernel<<<grid, Mla::THREADS, Mla::SMEM, stream>>>(
      tq, tk, static_cast<const int*>(tbl), static_cast<const int*>(lens),
      static_cast<float*>(out), static_cast<float*>(o), static_cast<float*>(lse), Hq, page,
      max_pages, S, scale);
  return static_cast<int>(cudaGetLastError());
}

// Ring stages: 3, or as many tiles as the table holds if fewer (a table of
// one tile needs one), or 2 where 3 do not fit.
inline int ring_stages(int max_pages, int page, int tile) {
  const int64_t tiles = (static_cast<int64_t>(max_pages) * page + tile - 1) / tile;
  return tiles < 3 ? (tiles < 1 ? 1 : static_cast<int>(tiles)) : 3;
}

}  // namespace

// Stage 1. out [B, Hq, dv] takes the requests of one split; o [B, S, Hq, dv]
// and lse [B, S, Hq] the splits of the others (both may be null when no
// request can be split); the pools hold pool_pages pages. Two tensor-core
// paths, chosen by shape and type: the shared pool of absorbed MLA (bf16 q
// and pool, Hkv 1, dk 576, dv 512, query heads a multiple of 64, pages of 8,
// 16 or 32: DeepSeek-V3) and GQA (bf16 q and pools, dk == dv in {64, 128},
// at most 16 heads per kv head, no shared pool: DBRX). Everything else runs
// on CUDA cores.
extern "C" int ep_paged_decode_stage1(const void* q, const void* kp, const void* vp,
                                      const void* tbl, const void* lens, void* out, void* o,
                                      void* lse, int B, int S, int Hq, int Hkv, int dk,
                                      int dv, int page, int max_pages, int pool_pages,
                                      float scale, int qdt, int kdt, int share_kv,
                                      void* stream) {
  if (dv > 4 * THREADS || dk % 8 || dv % 8 || S < 1 || Hkv < 1 || Hq % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (share_kv && kdt == BF16 && qdt == BF16 && Hkv == 1 && dk == Mla::DK && dv == Mla::DV &&
      G % Mla::HEADS == 0 && (page == 8 || page == 16 || page == 32)) {
    if (B == 0) return static_cast<int>(cudaGetLastError());
    return launch_mla(q, kp, tbl, lens, out, o, lse, B, S, Hq, page, max_pages, pool_pages,
                      scale, st);
  }
  if (!share_kv && kdt == BF16 && qdt == BF16 && dk == dv && (dk == 64 || dk == 128) &&
      G <= 16) {
    if (B == 0) return static_cast<int>(cudaGetLastError());
    const int stages = ring_stages(max_pages, page, FT);
    if (dk == 64)
      return launch_fast<64>(q, kp, vp, tbl, lens, out, o, lse, B, S, Hq, Hkv, page,
                             max_pages, stages, scale, st);
    return launch_fast<128>(q, kp, vp, tbl, lens, out, o, lse, B, S, Hq, Hkv, page,
                            max_pages, stages, scale, st);
  }
  const int qt = G < MAXQ ? G : MAXQ;
  const int ntiles = (G + qt - 1) / qt;
  const int elt = dtype_size(kdt);
  int stages = ring_stages(max_pages, page, TT);
  if (stages < 2) stages = 2;
  int64_t smem = layout(dk, dv, elt, qt, share_kv, stages).total;
  if (smem > SMEM_MAX && stages > 2) smem = layout(dk, dv, elt, qt, share_kv, --stages).total;
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  switch (kdt) {
    case F32:
      return dispatch_mq<float>(q, kp, vp, tbl, lens, out, o, lse, B, S, Hq, Hkv, dk, dv,
                                page, max_pages, qt, ntiles, stages, scale, qdt, share_kv,
                                smem, st);
    case BF16:
      return dispatch_mq<__nv_bfloat16>(q, kp, vp, tbl, lens, out, o, lse, B, S, Hq, Hkv, dk,
                                        dv, page, max_pages, qt, ntiles, stages, scale, qdt,
                                        share_kv, smem, st);
    case F16:
      return dispatch_mq<__half>(q, kp, vp, tbl, lens, out, o, lse, B, S, Hq, Hkv, dk, dv,
                                 page, max_pages, qt, ntiles, stages, scale, qdt, share_kv,
                                 smem, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Stage 2: the split requests only; the others were written by stage 1.
extern "C" int ep_paged_decode_stage2(const void* o, const void* lse, const void* lens,
                                      void* out, int B, int S, int Hq, int dv, int max_tokens,
                                      void* stream) {
  if (B > 0) {
    dim3 grid((Hq + HPB - 1) / HPB, B);
    paged_stage2_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(o), static_cast<const float*>(lse),
        static_cast<const int*>(lens), static_cast<float*>(out), S, Hq, dv, max_tokens);
  }
  return static_cast<int>(cudaGetLastError());
}
