// combine_gather_reduce: out[t] = sum_k w[t, k] * recv[rows[t, k]], summed in
// f32 and cast once, without building the [T, K, H] gathered tensor.
//
// Replaces src/repro/kernels/combine_gather_reduce.py:44 combine_gather_reduce
// (the Pallas kernel that revisits one VMEM tile over a sequential k grid
// axis). Bound by bytes: K row reads and one row write per token. It runs
// the weighted row reduce it shares with combine_reduce (reduce.cuh
// reduce_rows) over the rows it is given (IndexRows). What that design does
// about each cost of the first kernel (one block of 128 threads per (token,
// 1024-wide tile) walking k with an index load, a row load and an FMA in a
// chain: 7.7x its bound at DBRX's decode combine on an H100):
//
// - Round trips. A thread owns one 16-byte piece of one token's output (8
//   bf16 or f16 values, 4 f32). It reads the token's K row indices and
//   weights once (one int4 and one float4 load where K = 4 and both arrays
//   are 16-byte aligned, else scalar loads), then issues the 16-byte loads
//   of all its rows (up to 8 at a time, so every row of K <= 8) before the
//   first FMA: two dependent trips to memory a call instead of 2K.
// - Filling the card. Blocks of 64 threads over (token, tile of 64 pieces):
//   the decode combine (16 tokens, H 6144 bf16) has 192 blocks, more than
//   the card's 132 SMs.
// - Order. Each thread sums in f32 over k = 0..K-1 in that fixed order and
//   rounds once, so two calls give the same bits and a token's bits depend
//   only on its own rows and weights. A sentinel row (outside [0, R)) is not
//   loaded and adds nothing.
#include "reduce.cuh"

// The output has the input's dtype; the wrapper guarantees H % 8 == 0 and a
// 16-byte aligned recv.
extern "C" int ep_combine_gather_reduce(const void* recv, const void* rows,
                                        const void* w, void* out, int T, int R,
                                        int64_t H, int K, int dt, void* stream) {
  const IndexRows src{static_cast<const int*>(rows), R};
  const float* wf = static_cast<const float*>(w);
  const bool vec4 = K == 4 && aligned16(rows) && aligned16(w);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dt) {               // K == 0 writes zero rows
    case F32:
      return reduce_rows<PieceOf<F32>, PieceOf<F32>>(recv, src, wf, out, T, H, K, vec4, st);
    case BF16:
      return reduce_rows<PieceOf<BF16>, PieceOf<BF16>>(recv, src, wf, out, T, H, K, vec4, st);
    case F16:
      return reduce_rows<PieceOf<F16>, PieceOf<F16>>(recv, src, wf, out, T, H, K, vec4, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
