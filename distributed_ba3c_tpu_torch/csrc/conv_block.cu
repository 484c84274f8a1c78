// Fused BA3C conv block for Hopper (sm_90a), a tensor-core implicit GEMM:
//
//     y = maxpool2x2?(relu(bf16(conv_SAME(x, W)) + b))
//
// Replaces the TPU kernel distributed_ba3c_tpu/ops/pallas_conv.py:_fwd_kernel
// (launched by conv_block_fwd). The function is kept; the TPU layout is not:
// the lane packing (P=4 output columns per GEMM row), the 128-lane padding
// and the batch tile existed for Mosaic and the MXU. Every block of the net
// goes through it, conv0 included (its exclusion on the TPU was a Mosaic
// layout limit).
//
// Layouts (the JAX package's, kept at the wrapper's public signature):
//   x  [B, H, W, Ci]   uint8 (x * bf16(1/255), rounded once to bf16) or bf16
//   w  [kh, kw, Ci, Co] bf16 (HWIO)
//   b  [Co]             bf16
//   y  [B, Ho, Wo, Co]  bf16, Ho = H/2 and Wo = W/2 when pooled
// x, w and y must be 16-byte aligned.
//
// Numerics, op for op as the reference (pallas_conv.py:reference_block):
// bf16 x bf16 products summed in f32 (by the tensor cores, in their order),
// SAME zero padding with the top/left pad (k-1)/2, the sum rounded to bf16,
// the bf16 bias added with one bf16 rounding, relu, then the 2x2/2 max.
//
// The GEMM view. M is the pre-pool output positions of one sample, N = Co
// (32 or 64, all of it in one warp), K = kh*kw*Ci ordered (ky, kx, ci): the
// flattened HWIO weight is the [K, Co] matrix as it is. A row of A is never
// built: for tap (ky, kx) and 16 channels, the 16 A rows are 16 pixels of
// an input tile in shared memory, each 16-byte aligned, so ldmatrix reads
// A straight from the tile (no im2col buffer anywhere) and
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) does the products.
//
// Design:
//  - One CTA (4 warps) holds the block's whole weight matrix in shared
//    memory, [K][Co + 8] bf16 (<= 83 KB), loaded once with cp.async, and
//    walks work items (sample, band of output rows) with a grid stride, so
//    the weights are not reloaded per tile.
//  - Per item it loads the band's input halo, (rows*U + kh - 1) x (W + kw -
//    1) pixels, zero outside the image (SAME padding, block 2's asymmetric
//    1/2 pad included), into shared memory with cp.async; a uint8 input is
//    converted and scaled while it is loaded, with one rounding. The band
//    height is picked on the host from a cost model (whole warp rounds per
//    band, CTAs that fit on the card) and the shared memory it needs; on
//    an H100 it beat the fixed rule "the tallest band at which two CTAs fit
//    on an SM" by 13-45% on blocks 0-2 at B >= 128 (PERF.md).
//  - Each warp takes chunks of 32 pre-pool positions: 2 m16 fragments x
//    all Co/8 n8 fragments, 32 or 64 f32 accumulators a thread. When
//    pooled, the chunk is 8 pool windows, and the rows are laid out so that
//    the four positions of a window sit in one thread's accumulators (rows
//    g and g+8 of fragments 0 and 1): the 2x2 max happens in registers and
//    the pre-pool activation never reaches device memory, the property the
//    TPU kernel was built for. Pre-pool rows and columns that the pool
//    drops (block 2's 21st) are never computed.
//  - No shared-memory load has a bank conflict (tests/test_torch_conv_block.py
//    counts them on a lane-level mirror of this file's indexing). The
//    channel strides are padded (Ci + 8, Co + 8 when Ci/8, Co/8 are even),
//    so 8 consecutive pixels or weight rows fall on 8 different bank
//    groups. A pooled chunk's 8 windows are 2 pixels apart, which would put
//    two of an ldmatrix's rows on one bank group, so there the halo is
//    split: the even halo rows, then the odd ones, and in each row the even
//    columns, then the odd ones; a tap's 8 rows are then 8 consecutive
//    slots. The halo row pitch is padded to W/U mod 8 slots, so a chunk
//    that wraps to the next output row continues its bank sequence.
//  - Ci = 4 (block 0): a k16 step would span 4 taps. K runs instead by
//    kernel rows: the kw*Ci = 20 values of one kernel row are 20 contiguous
//    values of the unpadded halo row, padded to 32 with zero weights (K =
//    160 for 100, and the 12 extra A values are the real pixels to the
//    right, times 0). Those rows are only 8-byte aligned, so A is built
//    from 32-bit shared loads instead of ldmatrix.
//
// What bounds it on an H100 (chip_smoke.py's count: each input read once,
// each output written once, the operations of the pre-pool positions the
// output needs at 989 TFLOP/s dense bf16, bytes at 3.35 TB/s): block 0 by
// bytes, blocks 1 and 2 by operations, block 3 by bytes. This design moves
// the products to the tensor cores and keeps every re-read of inputs and
// weights in shared memory. It leaves for later (ROADMAP B1b): wgmma, TMA,
// warp specialisation and a double-buffered halo.
//
// The geometry, the loaders, the mainloop and the launch live in
// conv_block.cuh. The backward (conv_block_bwd.cu) has kernels of its own:
// its route recomputes these sums with wgmma in the same k16 steps, in
// the same order.
//
// Only the four BA3C blocks are instantiated, at any H and W: (kh, kw, Ci,
// Co, pool) = (5, 5, 4, 32, pooled) with a uint8 or bf16 input, (5, 5, 32,
// 32, pooled), (4, 4, 32, 64, pooled) and (3, 3, 64, 64, not pooled), bf16
// (ops/conv_block.py: KERNEL_GEOMETRIES). Any other geometry returns
// cudaErrorInvalidValue.

#include "conv_block.cuh"

// Plain C entry point (bound with ctypes). Launches on `stream` and returns
// a cudaError_t as an int: 0 when the launch was accepted; the error of the
// first-use setup (the shared-memory attribute, the occupancy query) or of
// the launch otherwise, and cudaErrorInvalidValue for a geometry that is
// not instantiated, cudaErrorMisalignedAddress for an unaligned x, w or y.
extern "C" int ba3c_conv_block_fwd(const void* x, int x_uint8, const void* w,
                                   const void* b, void* y, int B, int H, int W,
                                   int Ci, int Co, int kh, int kw, int pool,
                                   float scale, void* stream) {
  if (B == 0) return 0;
  if (B < 0 || H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(y)) & 15) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto is = [&](int KH, int CI, int CO, bool POOL) {
    return kh == KH && kw == KH && Ci == CI && Co == CO && (pool != 0) == POOL;
  };
  const auto fwd = [&](auto geom, auto in) {
    using G = decltype(geom);
    using TIn = decltype(in);
    return launch<G, TIn>(x, w, b, y, B, H, W, scale, s);
  };
  if (is(5, 4, 32, true)) {
    using G = Geom<5, 5, 4, 32, true>;
    return x_uint8 ? fwd(G{}, uint8_t{}) : fwd(G{}, bf16{});
  }
  if (x_uint8) return static_cast<int>(cudaErrorInvalidValue);
  if (is(5, 32, 32, true)) return fwd(Geom<5, 5, 32, 32, true>{}, bf16{});
  if (is(4, 32, 64, true)) return fwd(Geom<4, 4, 32, 64, true>{}, bf16{});
  if (is(3, 64, 64, false)) return fwd(Geom<3, 3, 64, 64, false>{}, bf16{});
  return static_cast<int>(cudaErrorInvalidValue);
}
