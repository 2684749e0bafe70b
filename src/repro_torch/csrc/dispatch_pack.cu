// dispatch_pack: gather token rows through the [N, C] slot map into the send
// buffer, optionally quantizing each row to block-wise fp8 e4m3.
//
// Replaces src/repro/kernels/dispatch_pack.py:42 dispatch_pack (the Pallas
// copy and quant kernels). The work is a row gather, so it is bound by bytes:
// each live slot reads one token row and writes one packed row. What the
// design does about each cost of a first, simpler kernel (one block per slot
// row, 2.4x to 3.5x its bound on an H100):
//
// - Copy mode (the decode dispatch and combine sends, the HT combine send)
//   runs the row gather it shares with recv_unpack (gather.cuh gather_rows):
//   a grid over (slot row, chunk of 768 16-byte pieces, a whole row of
//   DBRX's 6144 bf16) whose threads issue all six of their 16-byte loads
//   before their stores, so a decode call ([8, 16] slots of 12 KB) has every
//   load in flight in the first wave instead of six dependent load/store
//   pairs per thread. A sentinel slot (index outside [0, T)) stores zeros
//   without a load. A dtype change goes through f32 with
//   round-to-nearest-even, eight elements a thread-step.
// - Quant mode (the HT and deepep dispatch sends) runs the block fp8
//   quantizer it shares with quantize_fp8 (quant.cuh quantize_rows), over
//   the slot map's rows (MapRows): a persistent grid walks the slot rows,
//   reading the next row's slot index ahead. A quant block of qb = 8 * 2^k
//   elements (k <= 7; 128 on the path) belongs to a group of min(qb / 8, 32)
//   lanes that hold all of it in registers (at qb = 128 a warp quantizes two
//   blocks and no lane idles; up to four of a warp's blocks loaded before the
//   first is reduced): one read for both the amax and the rounding, scale =
//   amax / 448 by true division (1 for an all-zero block), each value divided
//   by the scale and rounded to e4m3 with satfinite, 8 bytes stored a lane.
//   A row's scales are gathered in shared memory and stored 16 bytes at a
//   time. A sentinel slot writes its zero row with 16-byte stores (8-byte
//   where H is not a multiple of 16) and scales of 1.0, as quantizing a zero
//   row would. Any other block width takes one warp per block (common.cuh
//   quant_block_warp). Both compute the same function, exactly: a max, one
//   division and one rounding per element.
#include "gather.cuh"
#include "quant.cuh"

extern "C" int ep_dispatch_pack_copy(const void* x, const void* gmap, void* out,
                                     int64_t rows, int T, int64_t H, int xdt, int odt,
                                     void* stream) {
  if (H % 8) return static_cast<int>(cudaGetLastError());
  return gather_rows(x, static_cast<const int*>(gmap), out, rows, T, H, xdt, odt,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int ep_dispatch_pack_quant(const void* x, const void* gmap, void* q,
                                      void* scales, int64_t rows, int T,
                                      int64_t H, int qb, int xdt, void* stream) {
  // the wrapper guarantees 16-byte aligned token rows and H % 8 == 0
  return quantize_rows(x, MapRows{static_cast<const int*>(gmap), T}, q, scales, rows, H, qb,
                       xdt, qb % 8 == 0, static_cast<cudaStream_t>(stream));
}

extern "C" const char* ep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
