// combine_reduce: out[t] = sum_k w[t, k] * y[t, k], summed in f32 and cast
// once, over the gathered [T, K, H] responses.
//
// Replaces src/repro/kernels/combine_reduce.py:32 combine_reduce (the Pallas
// kernel over (token-block, hidden-block) tiles holding all K responses).
// Bound by bytes: each response element is read once and each output
// element written once. It runs the weighted row reduce it shares with
// combine_gather_reduce (reduce.cuh reduce_rows), token t's rows being rows
// t * K .. t * K + K - 1 of y viewed as [T * K, H] (TokenRows: no index
// load, no sentinel). What that does about each cost of the first kernel
// (one block of 128 threads per (token, 1024-wide tile) whose threads walked
// k with a weight load, a row load and an FMA in a chain: 7.4x its bound at
// DBRX's decode width on an H100): a thread owns one 16-byte output piece
// and issues the loads of all its rows (up to 8 at a time) before the first
// FMA, two dependent trips to memory instead of 2K; blocks of 64 threads
// over (token, tile of 64 pieces) give 16 tokens of 6144 bf16 192 blocks
// for the card's 132 SMs, not 96. The weights are read in their own dtype
// (f32, bf16, f16); fp8 responses come in 8-byte pieces for 16-byte bf16
// output pieces. The sum runs over k = 0..K-1 in that fixed order and is
// rounded once, so two calls give the same bits, and with f32 weights the
// same bits as combine_gather_reduce over identity rows.
#include "reduce.cuh"

namespace {

template <class In, class Out>
int by_weights(const void* y, const void* w, void* out, int T, int64_t H, int K, int wdt,
               cudaStream_t st) {
  switch (wdt) {
    case F32:
      return reduce_rows<In, Out>(y, TokenRows{}, static_cast<const float*>(w), out, T, H, K,
                                  false, st);
    case BF16:
      return reduce_rows<In, Out>(y, TokenRows{}, static_cast<const __nv_bfloat16*>(w), out,
                                  T, H, K, false, st);
    case F16:
      return reduce_rows<In, Out>(y, TokenRows{}, static_cast<const __half*>(w), out, T, H, K,
                                  false, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The output has y's dtype (bf16 for fp8 y: odt must say so); the wrapper
// guarantees H % 8 == 0 and a 16-byte aligned y.
extern "C" int ep_combine_reduce(const void* y, const void* w, void* out, int T,
                                 int64_t H, int K, int ydt, int wdt, int odt,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (odt != (ydt == FP8E4M3 ? BF16 : ydt)) return static_cast<int>(cudaErrorInvalidValue);
  switch (ydt) {
    case F32: return by_weights<PieceOf<F32>, PieceOf<F32>>(y, w, out, T, H, K, wdt, st);
    case BF16: return by_weights<PieceOf<BF16>, PieceOf<BF16>>(y, w, out, T, H, K, wdt, st);
    case F16: return by_weights<PieceOf<F16>, PieceOf<F16>>(y, w, out, T, H, K, wdt, st);
    case FP8E4M3:
      return by_weights<PieceOf<FP8E4M3>, PieceOf<BF16>>(y, w, out, T, H, K, wdt, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
