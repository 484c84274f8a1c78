// The backward of the BA3C conv block for Hopper (sm_90a): three launches
// per block, each a hand-written tensor-core kernel.
//
// Replaces distributed_ba3c_tpu/ops/pallas_conv.py:_cb_bwd (lines 351-356),
// the custom VJP's backward, which recomputes reference_block in XLA and
// takes its VJP; its docstring's Pallas design ("unpool-scatter + packed
// dW/dx GEMMs") was never built there. With g the bf16 cotangent of
// y = maxpool2x2?(relu(z)), z = bf16(bf16(acc) + b), acc = conv_SAME(x, W):
//
//  (a) route (ba3c_conv_block_route, route_kernel): recomputes acc with
//      wgmma in the forward's k16 steps and order, so z matches the
//      forward's, and routes g back through the pool and the relu in
//      registers: a tile pair puts a whole pool window in one thread's
//      accumulators. It writes dz, the cotangent of acc, at pre-pool
//      resolution [B, U*Ho, U*Wo, Co] (block 2's 21st pre-pool row and
//      column are never formed: dz has 20 x 20, and the readers take what
//      lies outside as 0), and each CTA's f32 sums of dz (db partials).
//      Tie rules: reference_block's (relu'(0) = 1/2; the nested max splits
//      a tie evenly: the column pair of each window row, then the rows) or
//      flax's (relu'(0) = 0; a window's whole cotangent to its first
//      maximum, row-major). dz is g times 0, 1/8, 1/4, 1/2 or 1: exact.
//  (b) dgrad (ba3c_conv_block_dgrad, dgrad_kernel), blocks 1-3: dx =
//      conv(dz, W flipped in both taps, in and out swapped) with the pads
//      swapped (top/left k - 1 - (k - 1) / 2): an implicit GEMM with M the
//      forward's input positions, N = Ci (32 or 64), K = kh * kw * Co
//      ordered (tap of the flipped kernel, dz channel), the f32 sums
//      rounded to bf16 once.
//  (c) wgrad (ba3c_conv_block_wgrad, wgrad_kernel + wgrad_reduce_kernel):
//      dw[ky, kx, ci, co] = sum over b, y, x of xpad[b, y + ky - ph, x + kx
//      - pw, ci] * dz[b, y, x, co], a GEMM of M = K rows (kh * kw * Ci, or
//      for Ci = 4 kernel rows padded to 32) by N = Co, reducing over the B *
//      Hd * Wd positions of dz (18M for block 0 at B=2560).
//
// What bounds each kernel on an H100 (chip_smoke.py counts each input read
// once and each output written once, the operations at 989 TFLOP/s dense
// bf16, the bytes at 3.35 TB/s), and what the design does about it:
//
//  - The dgrad is bound by operations on blocks 1-2 and by bytes on block 3
//    (dz and dx, 33 MB each at B=2560). Persistent CTAs of two warpgroups
//    walk (sample, band) items, a contiguous run each. Each CTA reads the
//    weights once, straight from the forward's HWIO w: the tap flip and the
//    Ci/Co swap happen in the load, which lays B = W' [K][Ci] out K-major
//    in 64-wide K panels with wgmma's 128-byte swizzle, so no weight is
//    flipped or copied per call. A warpgroup takes a tile of 64 output
//    positions at a time: A is the im2col of the dz halo, read into registers
//    by ldmatrix two k steps ahead (no im2col buffer), B the weights
//    through a descriptor, wgmma.m64nNk16 the products.
//  - The wgrad is bound by bytes on blocks 0 and 3 (block 0's dz: 1.16 GB
//    at B=2560) and by operations on blocks 1-2. One CTA a resident slot
//    walks a contiguous run of (sample, band) items and owns all of K: the
//    K split lives inside the CTA, across its three warpgroups (m64 tiles
//    of K rows, round-robin), which share one loaded stage, so x and dz are
//    read once. Each k16 step takes 16 positions: A = the im2col^T of the
//    halo through ldmatrix.trans into registers, B = the dz tile through a
//    descriptor (MN-major, swizzled as TMA lays the [positions][Co] box
//    out). Block 0's Ci = 4 puts 2 pixels in 8 bf16, so its halo holds
//    pixel pairs (slot c = pixels c, c + 1), expanded in shared memory from
//    whole input rows (uint8 scaled there), and K runs by kernel rows padded
//    to 32 as in the forward. The partial sums cross CTAs in a fixed order:
//    the two CTAs of a thread-block cluster add their [K rows, Co] f32 sums
//    through distributed shared memory, rank 0's then rank 1's, and one
//    partial per cluster reaches device memory; wgrad_reduce_kernel adds
//    the partials of every element in a fixed order, the route's db
//    partials the same way, and rounds both to bf16. No float atomics: the
//    gradients are bit-identical from run to run.
//  - Both walk a ring of three shared-memory stages: thread 0 fills a stage
//    with TMA (a tensor map over the channels-last tensor, its
//    out-of-bounds zeros giving the pads; block 0's rows with bulk copies)
//    as soon as every warp is done with it, an mbarrier counting the bytes,
//    so the next two items land while one computes and no warp spends
//    instructions on copies. No branch sits between the products of a
//    k step (ptxas waits for the products in flight where control flow
//    merges): a warpgroup's tiles past the band or past K compute on
//    clamped rows and are not stored.
//  - What still bounds them: A comes from shared memory through ldmatrix,
//    2 KB a 64 x 16 tile, beside B's 1-2 KB, so shared-memory bandwidth
//    binds before the tensor cores do (a loop of only ldmatrix and wgmma
//    reaches about 55% of the dense rate on an H100; PERF.md).
//  - The route (route_kernel, its section below) is built from the same
//    parts: a TMA ring, ldmatrix-fed wgmma with no branch between the
//    products, dz out through a shared-memory box and a TMA store.
//  - Left for later: block 0's dz (1.16 GB at B=2560) still goes through
//    device memory from the route to the wgrad; fusing the two, or a
//    compact dz, would keep it on chip (ROADMAP S3c).
//
// Instantiated for the four BA3C blocks, at any H and W, as the forward
// (ops/conv_block.py: KERNEL_GEOMETRIES; the dgrad for blocks 1-3 only,
// DGRAD_GEOMETRIES; block 0's wgrad at W with whole 16-byte input rows).
// Any other geometry returns cudaErrorInvalidValue.

#include <cooperative_groups.h>
#include <cuda.h>

#include <initializer_list>
#include <mutex>

#include "conv_block.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kStages = 3;      // the ring: the item computed and two in flight
constexpr int kClusterCtas = 2;  // the wgrad's CTAs that add their sums on chip

// this thread's completed shared-memory writes become visible to wgmma
// (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of the warpgroup's wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving an accumulator's use across a wait
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets, layout (1: 128-byte swizzle, 2: 64-byte swizzle)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo & 0x3FFFF) >> 4) << 16) |
         (uint64_t((sbo & 0x3FFFF) >> 4) << 32) | (uint64_t(layout) << 62);
}

// d (m64 x N f32, the warpgroup's) += A (m64 x k16 bf16, from registers:
// each warp's 16 rows as mma.sync's A fragment) * B (k16 x N bf16, shared
// memory through desc; TB = 1: B is MN-major, 0: K-major). Thread (warp w,
// lane 4g + t) holds d[i] = row 16w + g + 8 * ((i >> 1) & 1), column
// 8 * (i >> 2) + 2t + (i & 1).
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc) {
  static_assert(N == 32 || N == 64, "wgmma_rs takes N = 32 or 64");
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TB));
  }
}

__host__ __device__ constexpr size_t align_up(size_t n, size_t a) { return (n + a - 1) / a * a; }

// p's first 1024-byte boundary of shared address
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// ---------------------------------------------------------------------------
// The ring: kStages shared-memory stages of (sample, band) items. Thread 0
// fills a stage with TMA (cp.async.bulk) and announces the bytes on
// full[s], which completes when they have landed; empty[s] completes when
// every warp is done with the stage.

// the dynamic shared memory's head: the ring's barriers, then up to the
// first 1024-byte boundary (the swizzled layouts repeat every 1024 bytes
// of shared address)
constexpr size_t kSmemHead = 2048;

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// the arrival of the thread that issues a stage's copies, and their bytes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// A box of a 4-D tensor map (coordinates innermost first; outside the
// tensor, zeros) into shared memory, counted on bar
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// `bytes` contiguous bytes (16-byte aligned, a multiple of 16) into shared
// memory, counted on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

struct Ring {
  uint64_t full[kStages], empty[kStages];

  // thread 0 sets the counts; every thread must pass a barrier before use
  __device__ void init(int warps) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], warps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  // Thread 0, as item it (of n) starts: the first kStages items' copies
  // into the empty ring, then, once every warp is done with item it - 1,
  // item it - 1 + kStages into its stage. issue(item, stage, full) announces
  // and starts an item's copies.
  template <class Issue>
  __device__ void refill(int it, int n, Issue issue) {
    if (threadIdx.x != 0) return;
    if (it == 0) {
      for (int j = 0; j < kStages && j < n; ++j) issue(j, j, &full[j]);
    } else if (it - 1 + kStages < n) {
      const int s = (it - 1) % kStages;
      mbar_wait(&empty[s], ((it - 1) / kStages) & 1);
      issue(it - 1 + kStages, s, &full[s]);
    }
  }
  __device__ void acquire(int it) { mbar_wait(&full[it % kStages], (it / kStages) & 1); }
  // a warp is done with item it's stage
  __device__ void release(int it) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[it % kStages]);
  }
};

// The byte offset of 16-byte chunk c of slot `slot` in a TMA box of SB-byte
// slots (a pixel's channels) laid out with the SB-byte swizzle: the chunk
// XORed with the slot's row phase
template <int SB>
__device__ __forceinline__ uint32_t swizzled(int slot, int c) {
  static_assert(SB == 64 || SB == 128, "the halos' slots are 64 or 128 bytes");
  const int phase = SB == 128 ? (slot & 7) : ((slot >> 1) & 3);
  return slot * SB + ((c ^ phase) << 4);
}

// cuTensorMapEncodeTiled, reached through the runtime (the build links no
// libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A map over a channels-last bf16 tensor [n, h, w, c] (c * 2 = 64 or 128
// bytes a pixel, that many bytes' swizzle), boxes of [1, bh, bw, c]; with
// a traversal stride, every stride-th row and column from the box's
// corner (a box then spans bh * stride rows and bw * stride columns)
int nhwc_map(CUtensorMap* map, const void* base, int n, int h, int w, int c, int bw, int bh,
             int stride = 1) {
  static EncodeTiled encode = nullptr;
  static int status = -1;
  static std::once_flag once;
  std::call_once(once, [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    status = e != cudaSuccess ? static_cast<int>(e)
             : found != cudaDriverEntryPointSuccess ? static_cast<int>(cudaErrorNotSupported)
                                                   : 0;
    encode = reinterpret_cast<EncodeTiled>(fn);
  });
  if (status) return status;
  if (c * 2 != 64 && c * 2 != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (bw * stride > 256 || bh * stride > 256 || stride < 1 || stride > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cuuint64_t dims[4] = {cuuint64_t(c), cuuint64_t(w), cuuint64_t(h), cuuint64_t(n)};
  const cuuint64_t strides[3] = {cuuint64_t(c) * 2, cuuint64_t(w) * c * 2,
                                 cuuint64_t(h) * w * c * 2};
  const cuuint32_t box[4] = {cuuint32_t(c), cuuint32_t(bw * stride), cuuint32_t(bh * stride), 1};
  const cuuint32_t steps[4] = {1, cuuint32_t(stride), cuuint32_t(stride), 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      c * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// (a) route
//
// route_kernel replaces the recompute that _cb_bwd (pallas_conv.py:351-356)
// leaves to XLA: z = bf16(bf16(conv_SAME(x, W)) + b) recomputed, then g
// routed back through the pool and the relu into dz, and the bias
// gradient's f32 partial sums. What bounds it on an H100 (chip_smoke.py's
// count: x, w, b and g read once, dz written once): block 0 by bytes (its
// dz alone is 1.16 GB at B=2560, 0.345 ms of a 0.43-0.45 ms bound), block 1
// by operations, blocks 2-3 by bytes. The design:
//
//  - Persistent CTAs walk a contiguous run of (sample, band of R output
//    rows) items through a ring of three stages. A producer warp (block 0:
//    a producer warpgroup) fills a stage with TMA: the x halo and the
//    band's g as tensor-map boxes (block 0: x's rows whole by bulk copy,
//    two items ahead, expanded by the producers to pixel pairs, uint8
//    scaled by bf16(1/255) with one rounding), and, once every consumer
//    warp is done with a band, stores its dz with one TMA store from a
//    shared-memory staging box [U * R rows, Wd, Co], swizzled as
//    WGeom::dz_offset reads it (rows past dz's last are clipped by the
//    map). No consumer spends a register or an instruction on a global
//    copy, and dz leaves in whole boxes; block 0 keeps three boxes, so two
//    stores can be in flight.
//  - The consumer warpgroups (three; two for block 2) take the band's
//    tiles round-robin, counted across the CTA's items so the warpgroups
//    stay even. A pooled tile is a pair of m64 tiles over 32 pool windows:
//    tile 0 their top pre-pool rows, tile 1 their bottom ones; warp w's
//    accumulator rows g and g + 8 are the left and right columns of window
//    8w + g, so each thread holds a whole window of its channels, and the
//    pool and relu route in registers (pool_route). Block 3's tile is 64
//    consecutive positions.
//  - The products: wgmma.m64nCOk16 with A from the halo by ldmatrix two k
//    steps ahead and B = the weights [K][Co] through a descriptor (the
//    forward's HWIO w as it is, MN-major: Co is w's contiguous axis), in
//    the forward's k16 steps and order: (ky, kx, 16 channels), or for
//    Ci = 4 kernel rows padded to 32 (10 steps), so each step sums the
//    same bf16 products as the forward's mma.sync step. Tile 1's A at
//    kernel row ky is tile 0's at ky + 1, so each fragment is loaded once
//    and serves both (KH + 1 fragments where 2 KH were). No branch sits
//    between the products of a step: tiles past the band compute on
//    clamped rows and are not stored.
//  - A pooled halo is four planes (row parity x column parity; TMA boxes
//    with a traversal stride of 2, or the producers' pair expansion), each
//    row padded to WO mod 8 slots, so the 8 windows of an ldmatrix, 2
//    pixels apart in the image, are 8 consecutive slots on 8 bank groups,
//    across a row wrap too. Block 3's halo rows are padded the same way.
//  - db: each thread's f32 sums, then the lanes, warps and warpgroups in a
//    fixed order, one partial a CTA; wgrad_reduce_kernel adds the partials
//    in a fixed order. No float atomics: bit-identical from run to run.
//  - What still bounds it (PERF.md): block 0's dz write, which only fusing
//    the route into block 0's wgrad (or a compact dz) removes; elsewhere
//    shared-memory traffic, A's ldmatrix and B's descriptor reads (each
//    wgmma of a tile pair reads B again), as in the dgrad and the wgrad.

// relu'(z): reference_block's maximum(z, 0) gives 1/2 at z == 0, flax's
// relu 0
__device__ __forceinline__ float relu_grad(float z, int flax) {
  return z > 0.f ? 1.f : (z == 0.f && !flax ? 0.5f : 0.f);
}

// The cotangent gv of a pool window's max, routed to its four positions
// q = 2 * row + column, through the pool and the relu. Every factor is a
// power of two, so each share is exact in bf16.
__device__ __forceinline__ void pool_route(const float (&z)[4], float gv, int flax,
                                           float (&d)[4]) {
  float r[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) r[q] = fmaxf(z[q], 0.f);
  if (flax) {
    // F.max_pool2d / nn.max_pool: all of it to the first maximum, row-major
    const float m = fmaxf(fmaxf(r[0], r[1]), fmaxf(r[2], r[3]));
    const int first = r[0] == m ? 0 : r[1] == m ? 1 : r[2] == m ? 2 : 3;
#pragma unroll
    for (int q = 0; q < 4; ++q) d[q] = q == first ? gv * relu_grad(z[q], 1) : 0.f;
  } else {
    // reference_block's nested max, the column pair of each window row
    // first, then the two rows; each max splits its cotangent evenly
    // among its tied arguments
    const float m0 = fmaxf(r[0], r[1]), m1 = fmaxf(r[2], r[3]);
    const float M = fmaxf(m0, m1);
    const float rs = m0 == M && m1 == M ? 0.5f : 1.f;
    const float m[2] = {m0, m1};
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const float gr = m[f] == M ? gv * rs : 0.f;
      const float cs = r[2 * f] == m[f] && r[2 * f + 1] == m[f] ? 0.5f : 1.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = 2 * f + h;
        d[q] = r[q] == m[f] ? gr * cs * relu_grad(z[q], 0) : 0.f;
      }
    }
  }
}

// smem -> global: a box of a 4-D tensor map from shared memory (outside
// the tensor: not written), in the thread's bulk group
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most N of the thread's bulk stores have not yet read their
// shared memory (the N last issued)
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// until the thread's bulk stores are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// a barrier of `count` threads (a multiple of 32) on hardware barrier `id`
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The route's layout of one geometry G (the forward's), WGS_ consumer
// warpgroups. A halo slot: a pixel's Ci channels (SB bytes, a TMA box's
// swizzled row) or, for Ci = 4, a pixel pair (16 bytes: pixels hc - PW and
// hc - PW + 1 of slot column hc). Pooled, the halo is NP = 4 planes (row
// parity, column parity) of plane_rows x pitch slots; else one plane.
template <class G, int WGS_>
struct RGeom {
  static constexpr int U = G::U;
  static constexpr int NP = G::POOL ? 4 : 1;
  static constexpr int SB = G::ROW ? 16 : G::CI * 2;
  static constexpr int N = G::CO;
  static constexpr int KSTEPS = G::KP / 16;
  static constexpr int DROW = N * 2;              // bytes of a pixel's Co channels
  static constexpr int SWZ = N == 64 ? 1 : 2;     // their swizzle: 128 B or 64 B
  static constexpr int KGROUP = 8 * DROW;
  static constexpr int MT = G::POOL ? 32 : 64;    // windows (positions) a tile
  static constexpr int NT = G::POOL ? 2 : 1;      // m64 tiles of a tile
  static constexpr int WGS = WGS_;                // consumer warpgroups
  static constexpr int CW = 4 * WGS;              // consumer warps
  static constexpr int PWARPS = G::ROW ? 4 : 1;   // producer warps
  static constexpr int THREADS = 32 * (CW + PWARPS);
  static constexpr size_t W_BYTES = align_up(size_t(G::KP) * DROW, 1024);
  // the bias (f32), then the warps' db sums
  static constexpr size_t RED_BYTES = align_up(size_t(CW + 1) * N * 4, 1024);
  // dz staging boxes: a band's box is reused NSTG items later, so the store
  // of item m - 2 may still be reading its box while item m is announced
  // (block 0's dz stores, 32 KB a band, are the kernel's largest)
  static constexpr int NSTG = G::ROW ? 3 : 2;
  static_assert(N == 32 || N == 64, "the route takes Co = 32 or 64");
  static_assert(G::ROW ? (G::CI == 4 && G::POOL && G::KROW == 32) : G::CI % 16 == 0,
                "the route takes Ci = 4 (pooled, pixel pairs) or a multiple of 16");

  static __host__ __device__ int halo_rows(int R) { return U * R + G::KH - 1; }
  static __host__ __device__ int plane_rows(int R) {
    return G::POOL ? (halo_rows(R) + 1) / 2 : halo_rows(R);
  }
  // the slot columns a plane row holds
  static __host__ __device__ int plane_cols(int W) {
    return G::POOL ? (G::halo_cols(W) + 1) / 2 : G::halo_cols(W);
  }
  // slots a plane row: plane_cols padded to W / U mod 8, so that a row
  // wrap moves 8 consecutive windows (positions) by whole rows of 8 slots
  static __host__ __device__ int pitch(int W) {
    const int c = plane_cols(W);
    return c + ((W / U - c) & 7);
  }
  static __host__ __device__ size_t plane_bytes(int W, int R) {
    return align_up(size_t(plane_rows(R)) * pitch(W) * SB, 1024);
  }
  static __host__ __device__ size_t g_bytes(int W, int R) {
    return align_up(size_t(R) * (W / U) * DROW, 1024);
  }
  // Ci = 4: the halo's input rows as they are (W * CI elements of esize)
  static __host__ __device__ size_t raw_bytes(int W, int R, int esize) {
    return G::ROW ? align_up(size_t(halo_rows(R)) * W * G::CI * esize, 1024) : 0;
  }
  static __host__ __device__ size_t stage_bytes(int W, int R) {
    return NP * plane_bytes(W, R) + g_bytes(W, R);
  }
  // a dz staging box [U * R rows, Wd, Co]
  static __host__ __device__ size_t staging_bytes(int W, int R) {
    return align_up(size_t(U * R) * (W / U * U) * DROW, 1024);
  }
  // the ring's stages, two buffers of input rows (Ci = 4), NSTG staging
  // boxes
  static size_t smem_bytes(int W, int R, int esize) {
    return kSmemHead + W_BYTES + RED_BYTES + kStages * stage_bytes(W, R) +
           2 * raw_bytes(W, R, esize) + NSTG * staging_bytes(W, R);
  }
  // The byte offset of row u's 16-byte chunk v (channels 8v .. 8v + 7) in a
  // box of DROW-byte rows, swizzled as TMA lays it out: the g box, the dz
  // staging box (WGeom::dz_offset) and the weights B[k][n] (row k)
  static __host__ __device__ int row_offset(int u, int v) {
    const int phase = N == 64 ? (u & 7) : ((u >> 1) & 3);
    return u * DROW + ((v ^ phase) << 4);
  }
};

// the route's barriers: full[s] (two arrivals: the producer's copies with
// their bytes, then the producer once the stage's halo is laid out and the
// item's dz staging box is free), empty[s] (every consumer warp), and for
// Ci = 4 raw[r] (an item's input rows landed in row buffer r)
struct RouteBars {
  uint64_t full[kStages], empty[kStages], raw[2];
};

// CTA p walks the items (sample, band of R output rows) i0 .. i0 + n - 1.
// tm_x maps x [B, H, W, CI] (pooled: boxes of a plane, traversal stride 2;
// unused for Ci = 4, whose rows come by bulk copy), tm_g g [B, HO, WO, CO]
// (boxes of R rows), tm_dz dz [B, Hd, Wd, CO] (boxes of U * R rows, stored).
// dbpart[p] takes the CTA's f32 sums of its dz.
template <class G, typename TIn, int WGS>
__global__ void __launch_bounds__(RGeom<G, WGS>::THREADS, 1)
    route_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_g,
                 const __grid_constant__ CUtensorMap tm_dz, const TIn* __restrict__ x,
                 const bf16* __restrict__ w, const bf16* __restrict__ b,
                 float* __restrict__ dbpart, int flax, int B, int H, int W, int R, int NB,
                 float scale) {
  using RG = RGeom<G, WGS>;
  constexpr int ES = sizeof(TIn);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  RouteBars& bars = *reinterpret_cast<RouteBars*>(smem_raw);
  unsigned char* smem = align_1024(smem_raw + sizeof(RouteBars));
  float* bias = reinterpret_cast<float*>(smem + RG::W_BYTES);
  float* red = bias + RG::N;
  unsigned char* stages = smem + RG::W_BYTES + RG::RED_BYTES;
  const size_t stage = RG::stage_bytes(W, R), plane = RG::plane_bytes(W, R);
  const size_t g_off = RG::NP * plane, rawb = RG::raw_bytes(W, R, ES);
  unsigned char* raws = stages + kStages * stage;
  unsigned char* staging = raws + 2 * rawb;
  const size_t stg = RG::staging_bytes(W, R);
  const int HO = H / G::U, WO = W / G::U, Wd = WO * G::U;
  const int pitch = RG::pitch(W), prows = RG::plane_rows(R);
  const int n_items = B * NB;
  const int i0 = int(static_cast<long long>(n_items) * blockIdx.x / gridDim.x);
  const int n = int(static_cast<long long>(n_items) * (blockIdx.x + 1) / gridDim.x) - i0;

  // the weights, once: B[kp][co], rows of Co (the HWIO w's own order; Ci = 4
  // pads each kernel row's KW * CI values to KROW with zeros)
  constexpr int WV = RG::N / 8;
  for (int i = threadIdx.x; i < G::KP * WV; i += RG::THREADS) {
    const int kp = i / WV, v = i - kp * WV;
    int src = kp;
    bool valid = true;
    if constexpr (G::ROW) {
      const int ky = kp / G::KROW, j = kp - ky * G::KROW;
      valid = j < G::KW * G::CI;
      src = valid ? ky * G::KW * G::CI + j : 0;
    }
    cp_async<16>(smem + RG::row_offset(kp, v), w + size_t(src) * RG::N + v * 8, valid);
  }
  for (int i = threadIdx.x; i < RG::N; i += RG::THREADS) bias[i] = __bfloat162float(b[i]);
  cp_async_wait_all();
  fence_async_smem();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bars.full[s], 2);
      mbar_init(&bars.empty[s], RG::CW);
    }
    for (int r = 0; r < 2; ++r) mbar_init(&bars.raw[r], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto item_at = [&](int j, int& bi, int& r0) {
    const int item = i0 + j;
    bi = item / NB;
    r0 = (item - bi * NB) * R;
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp >= RG::CW) {
    // ---- the producer. Item m: its halo laid out (Ci = 4: expanded from
    // the rows loaded two items ahead), then, once the consumers are done
    // with item m - 2, item m - 2's dz out and item m + 1's copies in,
    // and, once item m - NSTG's store has read its box, item m announced.
    const int pt = threadIdx.x - 32 * RG::CW;
    const int row_bytes = W * G::CI * ES;
    // Ci = 4: item j's input rows into row buffer j % 2
    auto load_rows = [&](int j) {
      int bi, r0;
      item_at(j, bi, r0);
      const int y0 = G::U * r0 - G::PH, lo = max(0, y0), hi = min(H, y0 + RG::halo_rows(R));
      uint64_t* bar = &bars.raw[j & 1];
      mbar_expect_tx(bar, uint32_t(max(0, hi - lo)) * row_bytes);
      for (int iy = lo; iy < hi; ++iy) {
        bulk_load(raws + (j & 1) * rawb + size_t(iy - y0) * row_bytes,
                  x + (size_t(bi) * H + iy) * W * G::CI, row_bytes, bar);
      }
    };
    // item j's TMA boxes into stage j % kStages: the halo planes (not for
    // Ci = 4) and g
    auto load_boxes = [&](int j) {
      int bi, r0;
      item_at(j, bi, r0);
      const int s = j % kStages;
      unsigned char* st = stages + s * stage;
      const uint32_t halo = G::ROW ? 0u : uint32_t(RG::NP) * prows * pitch * RG::SB;
      mbar_expect_tx(&bars.full[s], halo + uint32_t(R) * WO * RG::DROW);
      if constexpr (!G::ROW) {
        for (int p = 0; p < RG::NP; ++p) {
          tma_load_4d(st + p * plane, &tm_x, &bars.full[s], 0, -G::PW + (p & 1),
                      G::U * r0 - G::PH + (p >> 1), bi);
        }
      }
      tma_load_4d(st + g_off, &tm_g, &bars.full[s], 0, 0, r0, bi);
    };
    auto store = [&](int j) {  // item j's dz from its staging box
      int bi, r0;
      item_at(j, bi, r0);
      tma_store_4d(&tm_dz, staging + (j % RG::NSTG) * stg, 0, 0, G::U * r0, bi);
    };
    if (pt == 0 && n > 0) {
      if constexpr (G::ROW) {
        load_rows(0);
        if (n > 1) load_rows(1);
      }
      load_boxes(0);
    }
    for (int m = 0; m < n; ++m) {
      const int s = m % kStages;
      if constexpr (G::ROW) {
        // pair slot (hr, hc) = pixels hc - PW, hc - PW + 1 of halo row hr,
        // in plane (hr & 1, hc & 1) at (hr >> 1, hc >> 1); zero outside
        // the image, uint8 scaled by bf16(1/255) with one rounding. Stage
        // s is free: item m - 3's release was awaited
        int bi, r0;
        item_at(m, bi, r0);
        const int y0 = G::U * r0 - G::PH;
        mbar_wait(&bars.raw[m & 1], (m >> 1) & 1);
        const int cols = RG::plane_cols(W);
        const unsigned char* raw = raws + (m & 1) * rawb;
        unsigned char* st = stages + s * stage;
        // a producer warp a plane row at a time, a lane a slot
        for (int pw = pt >> 5; pw < RG::NP * prows; pw += RG::PWARPS) {
          const int p = pw / prows, pr = pw - p * prows;
          const int hr = 2 * pr + (p >> 1), iy = y0 + hr;
          for (int pc = pt & 31; pc < cols; pc += 32) {
            const int hc = 2 * pc + (p & 1);
            uint32_t v[4];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int ix = hc - G::PW + h;
              const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
              const unsigned char* src = raw + hr * row_bytes + ix * G::CI * ES;
              if constexpr (ES == 2) {
                const uint2 q = in ? *reinterpret_cast<const uint2*>(src) : make_uint2(0, 0);
                v[2 * h] = q.x;
                v[2 * h + 1] = q.y;
              } else {
                const uint32_t q = in ? *reinterpret_cast<const uint32_t*>(src) : 0u;
                v[2 * h] = pack_bf16x2(float(q & 0xff) * scale, float((q >> 8) & 0xff) * scale);
                v[2 * h + 1] =
                    pack_bf16x2(float((q >> 16) & 0xff) * scale, float(q >> 24) * scale);
              }
            }
            *reinterpret_cast<uint4*>(st + p * plane + (size_t(pr) * pitch + pc) * 16) =
                make_uint4(v[0], v[1], v[2], v[3]);
          }
        }
        named_sync(2, 32 * RG::PWARPS);  // row buffer m & 1 is free again
        if (pt == 0 && m + 2 < n) load_rows(m + 2);
      }
      if (m >= 2) {  // stage (m + 1) % kStages frees up, item m - 2's dz leaves
        mbar_wait(&bars.empty[(m - 2) % kStages], ((m - 2) / kStages) & 1);
        if (pt == 0) store(m - 2);
      }
      if (pt == 0) {
        if (m + 1 < n) load_boxes(m + 1);
        if (m >= RG::NSTG) bulk_wait_read<RG::NSTG - 2>();  // item m's box is free
        mbar_arrive(&bars.full[s]);
      }
    }
    for (int j = max(0, n - 2); j < n; ++j) {
      mbar_wait(&bars.empty[j % kStages], (j / kStages) & 1);
      if (pt == 0) store(j);
    }
    if (pt == 0) bulk_wait();
    return;
  }

  // ---- the consumers
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const uint32_t ws = smem_u32(smem);
  float dbs[RG::N / 8][2];
#pragma unroll
  for (int j = 0; j < RG::N / 8; ++j) dbs[j][0] = dbs[j][1] = 0.f;
  int done = 0;  // tiles of the CTA's earlier items
  for (int it = 0; it < n; ++it) {
    const int s = it % kStages;
    mbar_wait(&bars.full[s], (it / kStages) & 1);
    const int r0 = (i0 + it) % NB * R;
    const int units = min(R, HO - r0) * WO, tiles = (units + RG::MT - 1) / RG::MT;
    const uint32_t hs = smem_u32(stages + s * stage);
    const unsigned char* gs = stages + s * stage + g_off;
    unsigned char* dzs = staging + (it % RG::NSTG) * stg;
    for (int q = ((wg - done) % WGS + WGS) % WGS; q < tiles; q += WGS) {
      // A: lane l gives one row of its warp's 16 in each m64 tile; past the
      // band, the band's last window (position), computed and not stored
      uint32_t sl[2], pb[2];  // pooled: per kx parity, the slot and plane
      int slot0 = 0;          // not pooled: the position's slot
      if constexpr (G::POOL) {
        const int v = min(q * 32 + 8 * wl + (lane & 7), units - 1);
        const int uy = v / WO, ux = v - uy * WO, h = (lane >> 3) & 1;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          // halo column 2 ux + h + kx: column parity (h + kx) & 1, slot
          // column ux + ((h + kx) >> 1); Ci = 4 reads parity h only
          const int cp = G::ROW ? h : (h + p) & 1;
          sl[p] = uy * pitch + ux + (G::ROW ? 0 : (h + p) >> 1);
          pb[p] = hs + cp * plane;
        }
      } else {
        const int v = min(q * 64 + 16 * wl + (lane & 15), units - 1);
        slot0 = v / W * pitch + v % W;
      }
      // the A fragment of tile f at k step ks (both compile-time)
      auto a_addr = [&](int f, int ks) -> uint32_t {
        if constexpr (G::ROW) {
          // kernel row ky, pixels 4 sp .. 4 sp + 3 (pairs 2 sp, 2 sp + 1 of
          // the row's slot columns), the lane's pair c = lane >> 4
          const int ky = ks / 2, sp = ks % 2;
          return pb[0] + ((f + ky) & 1) * 2 * plane +
                 (sl[0] + ((f + ky) >> 1) * pitch + 2 * sp + (lane >> 4)) * 16;
        } else {
          const int tap = ks / (G::CI / 16), cc = ks % (G::CI / 16);
          const int ky = tap / G::KW, kx = tap % G::KW, chunk = 2 * cc + (lane >> 4);
          if constexpr (G::POOL) {
            const int slot = sl[kx & 1] + ((f + ky) >> 1) * pitch + (kx >> 1);
            return pb[kx & 1] + ((f + ky) & 1) * 2 * plane + swizzled<RG::SB>(slot, chunk);
          } else {
            return hs + swizzled<RG::SB>(slot0 + ky * pitch + kx, chunk);
          }
        }
      };
      float acc[RG::NT][RG::N / 2];
#pragma unroll
      for (int f = 0; f < RG::NT; ++f)
#pragma unroll
        for (int e = 0; e < RG::N / 2; ++e) acc[f][e] = 0.f;
      // A two k steps ahead; no branch between the products (ptxas waits
      // for the products in flight where control flow merges)
      if constexpr (G::POOL) {
        // tile 1 at kernel row ky reads what tile 0 reads at ky + 1 (its
        // windows' bottom pre-pool rows lie one row below their top ones):
        // each fragment is loaded once, for tile 1 (kernel row 0: for tile
        // 0 too), and taken again by tile 0 a kernel row later
        constexpr int SPR = RG::KSTEPS / G::KH;  // k steps a kernel row
        uint32_t fr[G::KH + 1][SPR][4];
        auto fetch = [&](int ks) {  // the fragments step ks is the first to take
          const int ky = ks / SPR, i = ks % SPR;
          if (ky == 0) ldsm_x4(fr[0][i], a_addr(0, ks));
          ldsm_x4(fr[ky + 1][i], a_addr(1, ks));
        };
        fetch(0);
        fetch(1);
#pragma unroll
        for (int ks = 0; ks < RG::KSTEPS; ++ks) {
          const int ky = ks / SPR, i = ks % SPR;
          const uint64_t desc =
              gmma_desc(ws + ks * 16 * RG::DROW, RG::KGROUP, RG::KGROUP, RG::SWZ);
          wgmma_fence();
          wgmma_rs<RG::N, 1>(acc[0], fr[ky][i], desc);
          wgmma_rs<RG::N, 1>(acc[1], fr[ky + 1][i], desc);
          wgmma_commit();
          wgmma_wait<1>();  // step ks - 1's fragments may be overwritten
          if (ks + 2 < RG::KSTEPS) fetch(ks + 2);
        }
      } else {
        uint32_t fa[3][4];
        ldsm_x4(fa[0], a_addr(0, 0));
        ldsm_x4(fa[1], a_addr(0, 1));
#pragma unroll
        for (int ks = 0; ks < RG::KSTEPS; ++ks) {
          const uint64_t desc =
              gmma_desc(ws + ks * 16 * RG::DROW, RG::KGROUP, RG::KGROUP, RG::SWZ);
          wgmma_fence();
          wgmma_rs<RG::N, 1>(acc[0], fa[ks % 3], desc);
          wgmma_commit();
          wgmma_wait<1>();  // step ks - 1 is done with fa[(ks + 2) % 3]
          if (ks + 2 < RG::KSTEPS) ldsm_x4(fa[(ks + 2) % 3], a_addr(0, ks + 2));
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int f = 0; f < RG::NT; ++f)
#pragma unroll
        for (int e = 0; e < RG::N / 2; ++e) fence_reg(acc[f][e]);

      // the epilogue: acc[f][4j + 2h + e] is row 16 wl + g + 8h of tile f,
      // channel 8j + 2t + e; g from the stage's box, dz into the staging box
      if constexpr (G::POOL) {
        const int v = q * 32 + 8 * wl + g;  // the thread's window
        if (v < units) {
          const int uy = v / WO, ux = v - uy * WO;
#pragma unroll
          for (int j = 0; j < RG::N / 8; ++j) {
            const __nv_bfloat162 gp =
                *reinterpret_cast<const __nv_bfloat162*>(gs + RG::row_offset(v, j) + 4 * t);
            const float gv[2] = {__low2float(gp), __high2float(gp)};
            float d[2][4];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float bj = bias[8 * j + 2 * t + e];
              float z[4];
#pragma unroll
              for (int qq = 0; qq < 4; ++qq) {
                z[qq] = pre_act(acc[qq >> 1][4 * j + 2 * (qq & 1) + e], bj);
              }
              pool_route(z, gv[e], flax, d[e]);
            }
#pragma unroll
            for (int qq = 0; qq < 4; ++qq) {
              const int u = (2 * uy + (qq >> 1)) * Wd + 2 * ux + (qq & 1);
              *reinterpret_cast<uint32_t*>(dzs + RG::row_offset(u, j) + 4 * t) =
                  pack_bf16x2(d[0][qq], d[1][qq]);
              dbs[j][0] += d[0][qq];
              dbs[j][1] += d[1][qq];
            }
          }
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int u = q * 64 + 16 * wl + g + 8 * h;
          if (u < units) {
#pragma unroll
            for (int j = 0; j < RG::N / 8; ++j) {
              const __nv_bfloat162 gp =
                  *reinterpret_cast<const __nv_bfloat162*>(gs + RG::row_offset(u, j) + 4 * t);
              const float d0 = __low2float(gp) *
                               relu_grad(pre_act(acc[0][4 * j + 2 * h], bias[8 * j + 2 * t]), flax);
              const float d1 =
                  __high2float(gp) *
                  relu_grad(pre_act(acc[0][4 * j + 2 * h + 1], bias[8 * j + 2 * t + 1]), flax);
              *reinterpret_cast<uint32_t*>(dzs + RG::row_offset(u, j) + 4 * t) =
                  pack_bf16x2(d0, d1);
              dbs[j][0] += d0;
              dbs[j][1] += d1;
            }
          }
        }
      }
    }
    done += tiles;
    fence_async_smem();  // the staging writes, before the TMA store reads them
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars.empty[s]);
  }

  // the CTA's db partial: over the 8 lanes that hold the same channels,
  // then the warps of a warpgroup, then the warpgroups, each in order
#pragma unroll
  for (int j = 0; j < RG::N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) dbs[j][e] += __shfl_xor_sync(0xffffffffu, dbs[j][e], o);
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < RG::N / 8; ++j) {
      red[warp * RG::N + 8 * j + 2 * lane] = dbs[j][0];
      red[warp * RG::N + 8 * j + 2 * lane + 1] = dbs[j][1];
    }
  }
  named_sync(1, 32 * RG::CW);
  for (int c = threadIdx.x; c < RG::N; c += 32 * RG::CW) {
    float sum = 0.f;
    for (int k = 0; k < WGS; ++k) {
      float part = 0.f;
      for (int i = 0; i < 4; ++i) part += red[(4 * k + i) * RG::N + c];
      sum += part;
    }
    dbpart[size_t(blockIdx.x) * RG::N + c] = sum;
  }
}

// The band: the R that minimises a cost model (the CTA's tiles, shared by
// its warpgroups, plus a fixed cost per item, over the CTAs that fit on the
// card, never below one band's round of tiles), among those whose stages
// fit; one CTA per resident slot or per item, whichever is fewer, and at
// most dbpart_cap (one db partial a CTA).
template <class G, typename TIn, int WGS>
int launch_route(const void* x, const void* w, const void* b, const void* g, void* dz,
                 void* dbpart, int dbpart_cap, int* n_dbpart, int flax, int B, int H, int W,
                 float scale, cudaStream_t stream) {
  using RG = RGeom<G, WGS>;
  constexpr int ES = sizeof(TIn);
  const auto kernel = route_kernel<G, TIn, WGS>;
  DeviceInfo d;
  using Tag = std::tuple<G, TIn, std::integral_constant<int, -3 - WGS>>;
  if (const int e = device_info<Tag>(kernel, RG::THREADS, &d)) return e;
  const int HO = H / G::U, WO = W / G::U, Hd = HO * G::U, Wd = WO * G::U;
  if (HO == 0 || WO == 0) return 0;
  // Ci = 4 copies whole rows of x: 16-byte multiples; the boxes' widths
  if ((G::ROW && (W * G::CI * ES) % 16) || RG::pitch(W) * (G::POOL ? 2 : 1) > 256 || Wd > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto band_cost = [&](int rows) {
    const int tiles = (rows * WO + RG::MT - 1) / RG::MT;
    return double(tiles) / WGS + 0.2;
  };
  int best_r = 0, best_slots = 0;
  double best = 0.0;
  for (int R = 1; R <= HO && G::U * R <= 256 && RG::plane_rows(R) * (G::POOL ? 2 : 1) <= 256;
       ++R) {
    const size_t smem = RG::smem_bytes(W, R, ES);
    if (smem > size_t(d.smem_block)) break;
    const int per_sm = std::min<long long>(d.ctas_by_regs, d.smem_sm / (smem + 1024));
    if (per_sm < 1) break;
    const int NB = (HO + R - 1) / R;
    const double full = band_cost(R), last = band_cost(HO - (NB - 1) * R);
    const int slots = std::min(per_sm * d.sms, dbpart_cap);
    const int band_rounds = ((R * WO + RG::MT - 1) / RG::MT + WGS - 1) / WGS;
    const double time = std::max(double(B) * ((NB - 1) * full + last) / slots,
                                 double(band_rounds));
    if (best_r == 0 || time < best) {
      best_r = R;
      best = time;
      best_slots = slots;
    }
  }
  if (best_r == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int NB = (HO + best_r - 1) / best_r;
  const long long items = static_cast<long long>(B) * NB;
  if (items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(std::min<long long>(items, best_slots));
  CUtensorMap tm_x, tm_g, tm_dz;
  if (const int e = nhwc_map(&tm_g, g, B, HO, WO, G::CO, WO, best_r)) return e;
  if (const int e = nhwc_map(&tm_dz, dz, B, Hd, Wd, G::CO, Wd, G::U * best_r)) return e;
  if constexpr (G::ROW) {
    tm_x = tm_g;  // unused: Ci = 4 copies x's rows
  } else if (const int e = nhwc_map(&tm_x, x, B, H, W, G::CI, RG::pitch(W),
                                    RG::plane_rows(best_r), G::POOL ? 2 : 1)) {
    return e;
  }
  kernel<<<grid, RG::THREADS, RG::smem_bytes(W, best_r, ES), stream>>>(
      tm_x, tm_g, tm_dz, static_cast<const TIn*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(b), static_cast<float*>(dbpart), flax, B, H, W, best_r, NB,
      scale);
  const int e = static_cast<int>(cudaGetLastError());
  if (e == 0) *n_dbpart = grid;
  return e;
}

// ---------------------------------------------------------------------------
// (b) dgrad

// G: the dgrad's conv geometry (dz's Co in as CI, the forward's Ci out as
// CO, unpooled, the swapped pads); WGS_ warpgroups a CTA
template <class G, int WGS_>
struct DGeom {
  static constexpr int N = G::CO;              // dx channels
  static constexpr int KSTEPS = G::KP / 16;    // k16 steps: (tap, 16 dz channels)
  static constexpr int PANELS = (G::KP + 63) / 64;
  static constexpr int PANEL = N * 128;        // bytes: N rows of 64 K values
  static constexpr int SB = G::CI * 2;         // bytes of a halo slot (a dz pixel)
  static constexpr int WGS = WGS_;             // warpgroups
  static constexpr int THREADS = 128 * WGS;
  static constexpr size_t W_BYTES = size_t(PANELS) * PANEL;
  static_assert(!G::ROW && G::CI % 16 == 0 && !G::POOL,
                "the dgrad takes dz channels in 16s");
  static __host__ __device__ int halo_rows(int R) { return R + G::KH - 1; }
  static __host__ __device__ size_t stage_bytes(int W, int R) {
    return align_up(size_t(halo_rows(R)) * G::halo_cols(W) * SB, 1024);
  }
  static size_t smem_bytes(int W, int R) {
    return kSmemHead + W_BYTES + kStages * stage_bytes(W, R);
  }
  // the weights' byte offset of B[k][n] (k a multiple of 8): K-major, the
  // 16-byte chunks of a 128-byte row XORed with the row's index mod 8
  static __host__ __device__ int w_offset(int k, int n) {
    return (k >> 6) * PANEL + n * 128 + ((((k & 63) >> 3) ^ (n & 7)) << 4);
  }
};

// Output positions (H x W of one sample, a band of R rows an item) x N;
// the items i0 .. i0 + n - 1 of this CTA, each its halo of dz rows r0 - PH
// .. r0 + R - 1 + KH - 1 - PH and columns -PW .. -PW + halo_cols - 1 (zero
// outside Hd x Wd), a TMA box of tm_dz (dz [B, Hd, Wd, CI]). w is the
// forward's HWIO [KH, KW, N, CI], dx [B, H, W, N].
template <class G, int WGS>
__global__ void __launch_bounds__(DGeom<G, WGS>::THREADS, 1)
    dgrad_kernel(const __grid_constant__ CUtensorMap tm_dz, const bf16* __restrict__ w,
                 bf16* __restrict__ dx, int B, int H, int W, int R, int NB) {
  using DG = DGeom<G, WGS>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Ring& ring = *reinterpret_cast<Ring*>(smem_raw);
  unsigned char* smem = align_1024(smem_raw + sizeof(Ring));
  const uint32_t ws = smem_u32(smem);
  const size_t stage = DG::stage_bytes(W, R);
  const int hwc = G::halo_cols(W);
  const int n_items = B * NB;
  const int i0 = int(static_cast<long long>(n_items) * blockIdx.x / gridDim.x);
  const int n = int(static_cast<long long>(n_items) * (blockIdx.x + 1) / gridDim.x) - i0;

  // the weights, once: B[k = (ky * KW + kx) * CI + c][n] = w[KH-1-ky][KW-1-kx][n][c],
  // the global reads in w's own order
  constexpr int CV = G::CI / 8, TAPS = G::KH * G::KW;
  for (int i = threadIdx.x; i < TAPS * DG::N * CV; i += DG::THREADS) {
    const int v = i % CV, c = (i / CV) % DG::N, src_tap = i / (CV * DG::N);
    const int k = (TAPS - 1 - src_tap) * G::CI + v * 8;
    cp_async<16>(smem + DG::w_offset(k, c), w + (size_t(src_tap) * DG::N + c) * G::CI + v * 8,
                 true);
  }
  cp_async_wait_all();
  fence_async_smem();
  ring.init(4 * DG::WGS);
  __syncthreads();

  const int wg = threadIdx.x >> 7, wl = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t box_bytes = uint32_t(DG::halo_rows(R)) * hwc * DG::SB;
  for (int it = 0; it < n; ++it) {
    ring.refill(it, n, [&](int j, int s, uint64_t* full) {
      const int item = i0 + j, bi = item / NB, r0 = (item - bi * NB) * R;
      mbar_expect_tx(full, box_bytes);
      tma_load_4d(smem + DG::W_BYTES + s * stage, &tm_dz, full, 0, -G::PW, r0 - G::PH, bi);
    });
    ring.acquire(it);
    const int item = i0 + it, bi = item / NB, r0 = (item - bi * NB) * R;
    const int units = min(R, H - r0) * W;
    const uint32_t hs = ws + uint32_t(DG::W_BYTES + (it % kStages) * stage);
    bf16* yb = dx + (size_t(bi) * H + r0) * W * DG::N;
    for (int tile = wg; tile * 64 < units; tile += DG::WGS) {
      // A: lane l gives this warp's position tile * 64 + 16 * wl + (l & 15)
      // (past the band: the band's last), chunk (l >> 4) of 16 channels
      const int u = min(tile * 64 + 16 * wl + (lane & 15), units - 1);
      const int slot0 = u / W * hwc + u % W;
      float acc[DG::N / 2];
#pragma unroll
      for (int e = 0; e < DG::N / 2; ++e) acc[e] = 0.f;
      auto load_a = [&](int ks, uint32_t(&f)[4]) {
        const int c = ks % (G::CI / 16), tap = ks / (G::CI / 16);
        const int ky = tap / G::KW, kx = tap - ky * G::KW;
        ldsm_x4(f, hs + swizzled<DG::SB>(slot0 + ky * hwc + kx, 2 * c + (lane >> 4)));
      };
      // A two k steps ahead: a step's ldmatrix overlaps the two products
      // before it. No branch between the products: ptxas waits for the
      // products in flight where control flow merges
      uint32_t fa[3][4];
      load_a(0, fa[0]);
      load_a(1, fa[1]);
#pragma unroll
      for (int ks = 0; ks < DG::KSTEPS; ++ks) {
        wgmma_fence();
        wgmma_rs<DG::N, 0>(acc, fa[ks % 3],
                           gmma_desc(ws + (ks >> 2) * DG::PANEL + (ks & 3) * 32, 16, 1024, 1));
        wgmma_commit();
        wgmma_wait<1>();  // step ks - 1 is done with fa[(ks + 2) % 3]
        if (ks + 2 < DG::KSTEPS) load_a(ks + 2, fa[(ks + 2) % 3]);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < DG::N / 2; ++e) fence_reg(acc[e]);
#pragma unroll
      for (int j = 0; j < DG::N / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int uo = tile * 64 + 16 * wl + g + 8 * h;
          if (uo < units) {
            *reinterpret_cast<uint32_t*>(yb + size_t(uo) * DG::N + 8 * j + 2 * t) =
                pack_bf16x2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
      }
    }
    ring.release(it);
  }
}

// The band: the R that minimises a cost model (rounds of WGS 64-position
// tiles per band plus a fixed cost per item, over the CTAs that fit on the
// card, never below one band's time); one CTA per resident slot or per
// item, whichever is fewer.
template <class G, int WGS>
int launch_dgrad(const void* dz, const void* w, void* dx, int B, int H, int W, int Hd, int Wd,
                 cudaStream_t stream) {
  using DG = DGeom<G, WGS>;
  const auto kernel = dgrad_kernel<G, WGS>;
  DeviceInfo d;
  using Tag = std::tuple<G, std::integral_constant<int, -2>, DG>;
  if (const int e = device_info<Tag>(kernel, DG::THREADS, &d)) return e;
  auto band_cost = [&](int rows) {
    const int tiles = (rows * W + 63) / 64;
    return double((tiles + DG::WGS - 1) / DG::WGS) + 0.15;
  };
  int best_r = 0, best_slots = 0;
  double best = 0.0;
  for (int R = 1; R <= H; ++R) {
    const size_t smem = DG::smem_bytes(W, R);
    if (smem > size_t(d.smem_block)) break;
    const int per_sm = std::min<long long>(d.ctas_by_regs, d.smem_sm / (smem + 1024));
    if (per_sm < 1) break;
    const int NB = (H + R - 1) / R;
    const double full = band_cost(R), last = band_cost(H - (NB - 1) * R);
    const int slots = per_sm * d.sms;
    const double time = std::max(double(B) * ((NB - 1) * full + last) / slots,
                                 std::max(full, last));
    if (best_r == 0 || time < best) {
      best_r = R;
      best = time;
      best_slots = slots;
    }
  }
  if (best_r == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int NB = (H + best_r - 1) / best_r;
  const long long items = static_cast<long long>(B) * NB;
  if (items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(std::min<long long>(items, best_slots));
  CUtensorMap tm_dz;
  if (const int e = nhwc_map(&tm_dz, dz, B, Hd, Wd, G::CI, G::halo_cols(W),
                             DG::halo_rows(best_r))) {
    return e;
  }
  kernel<<<grid, DG::THREADS, DG::smem_bytes(W, best_r), stream>>>(
      tm_dz, static_cast<const bf16*>(w), static_cast<bf16*>(dx), B, H, W, best_r, NB);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// (c) wgrad

// The wgrad's split of one geometry (G: the forward's geometry unpooled,
// whose positions are dz's). A halo slot: SB bytes of a pixel's channels
// (a TMA box, swizzled), or in row mode a pixel pair (16 bytes), expanded
// in shared memory from whole input rows. K rows: kh * kw * Ci in (ky, kx,
// ci) order, or in row mode chunks of 8 = a pixel pair of one kernel row,
// PAIRS a row, the rows of a fragment's two 8-row halves two chunks that
// each lane addresses on its own (kh * PAIRS = 15 chunks for block 0: two
// m64 tiles).
template <class G>
struct WGeom {
  static constexpr int SB = G::ROW ? 16 : G::CI * 2;
  static constexpr int PAIRS = (G::KW + 1) / 2;    // row mode: pixel pairs a kernel row
  static constexpr int CHUNKS = G::KH * PAIRS;     // row mode: 8-row chunks of K
  static constexpr int KP = G::ROW ? (CHUNKS * 8 + 63) / 64 * 64 : G::KP;  // K rows computed
  static constexpr int NF = KP / 16;               // m16 fragments of K
  static constexpr int TILES = (NF + 3) / 4;       // m64 tiles of K, one warp a fragment
  static constexpr int WGS = TILES < 3 ? TILES : 3;  // warpgroups
  static constexpr int TPW = (TILES + WGS - 1) / WGS;  // tiles of warpgroup 0
  static constexpr int AD = TPW <= 3 ? 3 : 2;      // k steps of A in registers
  static constexpr int THREADS = 128 * WGS;
  static constexpr int NACC = G::CO / 2;           // accumulators a thread per tile
  static constexpr int DROW = G::CO * 2;           // dz tile bytes per position
  static constexpr int SWZ = G::CO == 64 ? 1 : 2;  // its swizzle: 128 B or 64 B
  static constexpr int KGROUP = 8 * DROW;          // bytes of 8 positions
  static constexpr int CL = kClusterCtas;
  static_assert(G::ROW ? G::CI == 4 : G::CI % 16 == 0,
                "wgrad takes Ci = 4 (pixel pairs) or a multiple of 16");
  static_assert(G::CO == 32 || G::CO == 64, "wgrad takes Co = 32 or 64");

  static __host__ __device__ int halo_rows(int R) { return R + G::KH - 1; }
  // positions a stage holds: whole rotations of the A ring (AD k16 steps)
  static __host__ __device__ int tile_pos(int Wd, int R) {
    return (R * Wd + 16 * AD - 1) / (16 * AD) * (16 * AD);
  }
  static __host__ __device__ size_t dz_bytes(int Wd, int R) {
    return size_t(tile_pos(Wd, R)) * DROW;
  }
  // a stage's halo: the TMA box, or in row mode whole input rows of W * CI
  // elements of `esize` bytes
  static __host__ __device__ size_t halo_bytes(int W, int Wd, int R, int esize) {
    return align_up(G::ROW ? size_t(halo_rows(R)) * W * G::CI * esize
                           : size_t(halo_rows(R)) * G::halo_cols(Wd) * SB,
                    1024);
  }
  static __host__ __device__ size_t stage_bytes(int W, int Wd, int R, int esize) {
    return dz_bytes(Wd, R) + halo_bytes(W, Wd, R, esize);
  }
  // row mode: the pixel pairs, expanded from the stage's rows
  static __host__ __device__ size_t pair_bytes(int Wd, int R) {
    return G::ROW ? align_up(size_t(halo_rows(R)) * G::halo_pitch(Wd) * 16, 1024) : 0;
  }
  static constexpr size_t RED_BYTES = size_t(KP) * G::CO * 4;
  // the K row of weight k = (ky * KW + kx) * CI + ci
  static __host__ __device__ int kp_of(int k) {
    if (!G::ROW) return k;
    const int ky = k / (G::KW * G::CI), kx = k / G::CI % G::KW, ci = k % G::CI;
    return (ky * PAIRS + kx / 2) * 8 + (kx % 2) * G::CI + ci;
  }
  static size_t smem_bytes(int W, int Wd, int R, int esize) {
    return kSmemHead +
           std::max(kStages * stage_bytes(W, Wd, R, esize) + pair_bytes(Wd, R), RED_BYTES);
  }
  // the dz tile's byte offset of position u, channels 8v .. 8v + 7: rows
  // of DROW bytes, the 16-byte chunks XORed with the swizzle's row phase
  // (as TMA lays the box out)
  static __host__ __device__ int dz_offset(int u, int v) {
    const int phase = G::CO == 64 ? (u & 7) : ((u >> 1) & 3);
    return u * DROW + ((v ^ phase) << 4);
  }
};

// CTA p of a cluster of CL walks the items (sample, band of R dz rows) i0
// .. i0 + n - 1, all of K: warpgroup wg holds the m64 tiles wg, wg + WGS,
// .. (TPW or TPW - 1 of them, a count its code is compiled for), warp wl of
// it fragment 4 * tile + wl. The cluster's f32 sums, rank
// 0's plus rank 1's, go to part[cluster][kp][co]. tm_dz maps dz [B, Hd,
// Wd, CO] (boxes of R rows), tm_x x [B, H, W, CI] (boxes of the halo; row
// mode reads x's rows with bulk copies).
template <class G, typename TIn>
__global__ void __launch_bounds__(WGeom<G>::THREADS, 1)
    wgrad_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_dz, const TIn* __restrict__ x,
                 float* __restrict__ part, int B, int H, int W, int Hd, int Wd, int R, int NB,
                 float scale) {
  using WG = WGeom<G>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Ring& ring = *reinterpret_cast<Ring*>(smem_raw);
  unsigned char* smem = align_1024(smem_raw + sizeof(Ring));
  constexpr int ES = sizeof(TIn);
  const size_t stage = WG::stage_bytes(W, Wd, R, ES), dzb = WG::dz_bytes(Wd, R);
  bf16* pairs = reinterpret_cast<bf16*>(smem + kStages * stage);
  float* red = reinterpret_cast<float*>(smem);  // the sums, once the ring is drained
  const int hwc = G::halo_cols(Wd), pitch = G::halo_pitch(Wd);
  const int n_items = B * NB;
  const int i0 = int(static_cast<long long>(n_items) * blockIdx.x / gridDim.x);
  const int n = int(static_cast<long long>(n_items) * (blockIdx.x + 1) / gridDim.x) - i0;
  const int wg = threadIdx.x >> 7, wl = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // the dz tiles' positions past a box of R rows stay 0
  for (int s = 0; s < kStages; ++s) {
    for (int i = R * Wd * WG::DROW + threadIdx.x * 16; i < int(dzb); i += WG::THREADS * 16) {
      *reinterpret_cast<uint4*>(smem + s * stage + i) = make_uint4(0, 0, 0, 0);
    }
  }
  fence_async_smem();
  ring.init(4 * WG::WGS);
  __syncthreads();

  // the warpgroup's NT tiles over all items, then its sums into red
  auto consume = [&](auto nt_tag) {
    constexpr int NT = decltype(nt_tag)::value;
    float acc[NT][WG::NACC];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < WG::NACC; ++e) acc[i][e] = 0.f;
    const int hpitch = G::ROW ? pitch : hwc;  // the halo's slots a row
    const int half = (lane >> 3) & 1;          // which 8-row half of a fragment
    // each tile's fragment for this lane: its rows' slot offset from a
    // position's slot and their 16-byte chunk (fragments and chunks past K
    // repeat the last; never written)
    int toff[NT], tch[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int mf = min((wg + WG::WGS * i) * 4 + wl, WG::NF - 1);
      if constexpr (G::ROW) {  // chunk 2 mf + half: pixel pair p of kernel row ky
        const int c = min(2 * mf + half, WG::CHUNKS - 1);
        toff[i] = c / WG::PAIRS * pitch + 2 * (c % WG::PAIRS);
        tch[i] = 0;
      } else {  // tap (ky, kx), channels c .. c + 15
        const int tap = mf * 16 / G::CI, c = mf * 16 - tap * G::CI;
        const int ky = tap / G::KW, kx = tap - ky * G::KW;
        toff[i] = ky * hwc + kx;
        tch[i] = c / 8 + half;
      }
    }
    for (int it = 0; it < n; ++it) {
      ring.refill(it, n, [&](int j, int s, uint64_t* full) {
        const int item = i0 + j, bi = item / NB, r0 = (item - bi * NB) * R;
        unsigned char* st = smem + s * stage;
        if constexpr (G::ROW) {
          const int row_bytes = W * G::CI * ES;
          const int lo = max(0, r0 - G::PH), hi = min(H, r0 - G::PH + WG::halo_rows(R));
          mbar_expect_tx(full,
                         uint32_t(R) * Wd * WG::DROW + uint32_t(max(0, hi - lo)) * row_bytes);
          tma_load_4d(st, &tm_dz, full, 0, 0, r0, bi);
          for (int iy = lo; iy < hi; ++iy) {
            bulk_load(st + dzb + size_t(iy - (r0 - G::PH)) * row_bytes,
                      x + (size_t(bi) * H + iy) * W * G::CI, row_bytes, full);
          }
        } else {
          mbar_expect_tx(full, uint32_t(R) * Wd * WG::DROW +
                                   uint32_t(WG::halo_rows(R)) * hwc * WG::SB);
          tma_load_4d(st, &tm_dz, full, 0, 0, r0, bi);
          tma_load_4d(st + dzb, &tm_x, full, 0, -G::PW, r0 - G::PH, bi);
        }
      });
      ring.acquire(it);
      const int item = i0 + it, bi = item / NB, r0 = (item - bi * NB) * R;
      const int rows = min(R, Hd - r0), units = rows * Wd;
      const uint32_t dzt = smem_u32(smem + (it % kStages) * stage);
      uint32_t hs = dzt + uint32_t(dzb);
      if constexpr (G::ROW) {
        // the pixel pairs (hc - PW, hc - PW + 1) of halo row hr into slot
        // (hr, hc) from the stage's rows; zero outside the image, uint8
        // scaled by bf16(1/255) with one rounding
        const unsigned char* raw = smem + (it % kStages) * stage + dzb;
        const int row_bytes = W * G::CI * ES;
        __syncthreads();  // the last item's reads of the pairs are done
        for (int e = threadIdx.x; e < (rows + G::KH - 1) * hwc; e += WG::THREADS) {
          const int hr = e / hwc, hc = e - hr * hwc, iy = r0 - G::PH + hr;
          uint32_t v[4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ix = hc - G::PW + h;
            const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
            const unsigned char* p = raw + hr * row_bytes + ix * G::CI * ES;
            if constexpr (ES == 2) {
              const uint2 q = in ? *reinterpret_cast<const uint2*>(p) : make_uint2(0, 0);
              v[2 * h] = q.x;
              v[2 * h + 1] = q.y;
            } else {
              const uint32_t q = in ? *reinterpret_cast<const uint32_t*>(p) : 0u;
              v[2 * h] = pack_bf16x2(float(q & 0xff) * scale, float((q >> 8) & 0xff) * scale);
              v[2 * h + 1] = pack_bf16x2(float((q >> 16) & 0xff) * scale, float(q >> 24) * scale);
            }
          }
          *reinterpret_cast<uint4*>(pairs + (hr * pitch + hc) * 8) =
              make_uint4(v[0], v[1], v[2], v[3]);
        }
        __syncthreads();
        hs = smem_u32(pairs);
      }
      const int steps = WG::tile_pos(Wd, rows) / 16;
      // A: lane l gives position u = 16 ks + (l >> 4) * 8 + (l & 7) (past
      // the band: the band's last; its dz is 0) for its half's rows. The
      // loads come in step order: u's column and halo slot advance by 16
      // positions a step, wrapping rows, with no division
      const int u0 = (lane >> 4) * 8 + (lane & 7);
      const int last = (rows - 1) * hpitch + Wd - 1;  // the band's last position's slot
      int ux = u0 % Wd, uslot = (u0 / Wd) * hpitch + ux;
      auto load_a = [&](int ks, uint32_t(&f)[NT][4]) {
        const int slot = ks * 16 + u0 < units ? uslot : last;
        // 16 positions on: one or (Wd < 16) two row wraps, without a branch
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int wrap = ux + 16 * (1 - r) >= Wd;
          ux += 16 * (1 - r) - wrap * Wd;
          uslot += 16 * (1 - r) + wrap * (hpitch - Wd);
        }
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          if constexpr (G::ROW) {
            ldsm_x4_trans(f[i], hs + (slot + toff[i]) * 16);
          } else {
            ldsm_x4_trans(f[i], hs + swizzled<WG::SB>(slot + toff[i], tch[i]));
          }
        }
      };
      // the products of step ks, then, once step ks - 1 is done with them,
      // A of step ks + AD - 1 into `next`. No branch between the products
      // (ptxas waits for the products in flight where control flow
      // merges): the ring rotates whole, steps being a multiple of AD
      auto step = [&](int ks, const uint32_t(&cur)[NT][4], uint32_t(&next)[NT][4]) {
        const uint64_t desc =
            gmma_desc(dzt + ks * 16 * WG::DROW, WG::KGROUP, WG::KGROUP, WG::SWZ);
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < NT; ++i) wgmma_rs<G::CO, 1>(acc[i], cur[i], desc);
        wgmma_commit();
        wgmma_wait<1>();
        load_a(ks + WG::AD - 1, next);
      };
      uint32_t fa[WG::AD][NT][4];
      load_a(0, fa[0]);
      if constexpr (WG::AD == 3) {
        load_a(1, fa[1]);
        for (int ks = 0; ks < steps; ks += 3) {
          step(ks, fa[0], fa[2]);
          step(ks + 1, fa[1], fa[0]);
          step(ks + 2, fa[2], fa[1]);
        }
      } else {
        for (int ks = 0; ks < steps; ks += 2) {
          step(ks, fa[0], fa[1]);
          step(ks + 1, fa[1], fa[0]);
        }
      }
      wgmma_wait<0>();  // the products have read the stage's dz tile
      ring.release(it);
    }
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < WG::NACC; ++e) fence_reg(acc[i][e]);
    __syncthreads();  // the ring is drained: its memory takes the sums
    // the warpgroup's sums as red[kp][co]: fragment mf's rows mf * 16 + g
    // (+ 8), channels 8j + 2t, 8j + 2t + 1
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int mf = (wg + WG::WGS * i) * 4 + wl;
      if (mf >= WG::NF) continue;
#pragma unroll
      for (int j = 0; j < G::CO / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kp = mf * 16 + g + 8 * h;
          *reinterpret_cast<float2*>(red + kp * G::CO + 8 * j + 2 * t) =
              make_float2(acc[i][4 * j + 2 * h], acc[i][4 * j + 2 * h + 1]);
        }
      }
    }
  };
  if ((WG::TILES - wg + WG::WGS - 1) / WG::WGS == WG::TPW) {
    consume(std::integral_constant<int, WG::TPW>{});
  } else if constexpr (WG::TPW > 1) {
    consume(std::integral_constant<int, WG::TPW - 1>{});
  }

  // the cluster's partial: rank r adds slice r of every rank's sums, in
  // rank order, through distributed shared memory
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = static_cast<int>(cluster.block_rank());
  constexpr int NE = WG::KP * G::CO;
  float* out = part + size_t((blockIdx.x - rank) / WG::CL) * NE;
  for (int e = NE * rank / WG::CL + threadIdx.x; e < NE * (rank + 1) / WG::CL;
       e += WG::THREADS) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < WG::CL; ++r) s += cluster.map_shared_rank(red, r)[e];
    out[e] = s;
  }
  cluster.sync();  // no CTA leaves while another reads its sums
}

// dw (HWIO) = bf16 of the P partials summed in a fixed order, weight k at
// K row WGeom::kp_of(k); db = bf16 of the route's n_dbpart partials the
// same way. A CTA takes 32 consecutive outputs (dw's K * CO, then db's
// CO); its warp r adds run r of the kReduceRuns contiguous runs of the
// partials in order, a lane an output (the warp's reads coalesce), then
// warp 0 adds the runs' sums in run order.
constexpr int kReduceRuns = 8;

template <class G>
__global__ void __launch_bounds__(32 * kReduceRuns)
    wgrad_reduce_kernel(const float* __restrict__ part, int P,
                        const float* __restrict__ dbpart, int n_dbpart,
                        bf16* __restrict__ dw, bf16* __restrict__ db) {
  using WG = WGeom<G>;
  constexpr int NW = G::KH * G::KW * G::CI * G::CO;
  __shared__ float runs[kReduceRuns][32];
  const int r = threadIdx.x >> 5, i = blockIdx.x * 32 + (threadIdx.x & 31);
  float s = 0.f;
  if (i < NW) {
    const int k = i / G::CO, co = i - k * G::CO;
    const float* src = part + size_t(WG::kp_of(k)) * G::CO + co;
#pragma unroll 4
    for (int p = P * r / kReduceRuns; p < P * (r + 1) / kReduceRuns; ++p) {
      s += src[size_t(p) * WG::KP * G::CO];
    }
  } else if (i < NW + G::CO) {
    const float* src = dbpart + (i - NW);
#pragma unroll 4
    for (int p = n_dbpart * r / kReduceRuns; p < n_dbpart * (r + 1) / kReduceRuns; ++p) {
      s += src[size_t(p) * G::CO];
    }
  }
  runs[r][threadIdx.x & 31] = s;
  __syncthreads();
  if (r == 0 && i < NW + G::CO) {
    for (int j = 1; j < kReduceRuns; ++j) s += runs[j][threadIdx.x];
    if (i < NW) {
      dw[i] = __float2bfloat16(s);
    } else {
      db[i - NW] = __float2bfloat16(s);
    }
  }
}

// How many clusters of `threads`-thread CTAs with `smem` bytes each fit on
// the card at once, asked once per kernel, device and smem size.
template <class Kernel>
int max_clusters(Kernel kernel, int threads, size_t smem, int* out) {
  struct Entry {
    int dev = -1;
    size_t smem = 0;
    int n = 0;
  };
  static Entry cache[8];
  static std::mutex mu;
  int dev = 0;
  if (const cudaError_t e = cudaGetDevice(&dev)) return static_cast<int>(e);
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& c : cache) {
    if (c.dev == dev && c.smem == smem) {
      *out = c.n;
      return 0;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(kClusterCtas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg)) {
    return static_cast<int>(e);
  }
  static int next = 0;
  cache[next] = Entry{dev, smem, n};
  next = (next + 1) % 8;
  *out = n;
  return 0;
}

// The band: the R that minimises ceil(items / CTAs) * (k16 steps of a band
// + two steps' worth of fixed cost), among those whose ring fits. The grid:
// whole clusters, as many as fit on the card at once, at most part_cap
// clusters and one CTA per item.
template <class G, typename TIn>
int launch_wgrad(const void* x, const void* dz, const void* dbpart, int n_dbpart,
                 void* part, int part_cap, void* dw, void* db, int B, int H, int W,
                 int Hd, int Wd, float scale, cudaStream_t stream) {
  using WG = WGeom<G>;
  constexpr int ES = sizeof(TIn);
  const auto kernel = wgrad_kernel<G, TIn>;
  DeviceInfo d;
  using Tag = std::tuple<G, TIn, std::integral_constant<int, -1>>;
  if (const int e = device_info<Tag>(kernel, WG::THREADS, &d)) return e;
  // row mode copies whole rows of x: 16-byte multiples
  if (part_cap < 1 || (G::ROW && (W * G::CI * ES) % 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int best_r = 0, best_grid = 0;
  double best = 0.0;
  for (int R = 1; R <= Hd; ++R) {
    const size_t smem = WG::smem_bytes(W, Wd, R, ES);
    if (smem > size_t(d.smem_block)) break;
    int clusters = 0;
    if (const int e = max_clusters(kernel, WG::THREADS, smem, &clusters)) return e;
    const int NB = (Hd + R - 1) / R;
    const long long items = static_cast<long long>(B) * NB;
    const long long cap = std::min<long long>(clusters, part_cap);
    const long long grid = WG::CL * std::max<long long>(
        1, std::min<long long>(cap, (items + WG::CL - 1) / WG::CL));
    const double time = double((items + grid - 1) / grid) * (WG::tile_pos(Wd, R) / 16 + 2);
    if (clusters >= 1 && (best_r == 0 || time < best)) {
      best_r = R;
      best = time;
      best_grid = static_cast<int>(grid);
    }
  }
  if (best_r == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int NB = (Hd + best_r - 1) / best_r;
  if (static_cast<long long>(B) * NB > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tm_x, tm_dz;
  if (const int e = nhwc_map(&tm_dz, dz, B, Hd, Wd, G::CO, Wd, best_r)) return e;
  if constexpr (G::ROW) {
    tm_x = tm_dz;  // unused: row mode copies x's rows
  } else {
    if (const int e = nhwc_map(&tm_x, x, B, H, W, G::CI, G::halo_cols(Wd),
                               WG::halo_rows(best_r))) {
      return e;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = WG::CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(best_grid);
  cfg.blockDim = dim3(WG::THREADS);
  cfg.dynamicSmemBytes = WG::smem_bytes(W, Wd, best_r, ES);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, tm_x, tm_dz, static_cast<const TIn*>(x),
                                     static_cast<float*>(part), B, H, W, Hd, Wd, best_r, NB,
                                     scale);
  if (e != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  constexpr int ne = G::KH * G::KW * G::CI * G::CO + G::CO;
  wgrad_reduce_kernel<G><<<(ne + 31) / 32, 32 * kReduceRuns, 0, stream>>>(
      static_cast<const float*>(part), best_grid / WG::CL,
      static_cast<const float*>(dbpart), n_dbpart, static_cast<bf16*>(dw),
      static_cast<bf16*>(db));
  return static_cast<int>(cudaGetLastError());
}

bool misaligned(std::initializer_list<const void*> ptrs) {
  uintptr_t any = 0;
  for (const void* p : ptrs) any |= reinterpret_cast<uintptr_t>(p);
  return any & 15;
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream` and
// returns a cudaError_t as an int: 0 when the launches were accepted,
// cudaErrorInvalidValue for a geometry without a kernel or a bad size,
// cudaErrorMisalignedAddress for a pointer that is not 16-byte aligned.
// H, W, Ci, Co, kh, kw and pool are the forward block's; U = 2 when pooled,
// else 1, and dz's grid is Hd x Wd = U * (H / U) x U * (W / U).

// (a) dz [B, Hd, Wd, Co] and the db partials dbpart [*n_dbpart, Co] f32
// (at most dbpart_cap rows) from the forward's inputs and g, the cotangent
// of y [B, H / U, W / U, Co]. flax: the tie rule, 0 reference_block's, 1
// flax's.
extern "C" int ba3c_conv_block_route(const void* x, int x_uint8, const void* w,
                                     const void* b, const void* g, void* dz,
                                     void* dbpart, int dbpart_cap, int* n_dbpart,
                                     int flax, int B, int H, int W, int Ci, int Co,
                                     int kh, int kw, int pool, float scale,
                                     void* stream) {
  *n_dbpart = 0;
  if (B == 0) return 0;
  if (B < 0 || H <= 0 || W <= 0 || dbpart_cap < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (misaligned({x, w, g, dz, dbpart})) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto is = [&](int KH, int CI, int CO, bool POOL) {
    return kh == KH && kw == KH && Ci == CI && Co == CO && (pool != 0) == POOL;
  };
  // consumer warpgroups a CTA as measured best on an H100 (PERF.md): three,
  // but two for block 2, whose tile pair holds 64 accumulators a thread
  // and spills in the 128 registers that three warpgroups leave
  const auto route = [&](auto geom, auto in, auto wgs) {
    using G = decltype(geom);
    using TIn = decltype(in);
    return launch_route<G, TIn, decltype(wgs)::value>(x, w, b, g, dz, dbpart, dbpart_cap,
                                                      n_dbpart, flax != 0, B, H, W, scale, s);
  };
  using Two = std::integral_constant<int, 2>;
  using Three = std::integral_constant<int, 3>;
  if (is(5, 4, 32, true)) {
    using G = Geom<5, 5, 4, 32, true>;
    return x_uint8 ? route(G{}, uint8_t{}, Three{}) : route(G{}, bf16{}, Three{});
  }
  if (x_uint8) return static_cast<int>(cudaErrorInvalidValue);
  if (is(5, 32, 32, true)) return route(Geom<5, 5, 32, 32, true>{}, bf16{}, Three{});
  if (is(4, 32, 64, true)) return route(Geom<4, 4, 32, 64, true>{}, bf16{}, Two{});
  if (is(3, 64, 64, false)) return route(Geom<3, 3, 64, 64, false>{}, bf16{}, Three{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// (b) dx [B, H, W, Ci] bf16 from dz and w, the forward's HWIO weight [kh,
// kw, Ci, Co] as it is (the kernel flips it as it loads it). Blocks 1-3.
extern "C" int ba3c_conv_block_dgrad(const void* dz, const void* w, void* dx, int B,
                                     int H, int W, int Ci, int Co, int kh, int kw,
                                     int pool, void* stream) {
  if (B == 0) return 0;
  if (B < 0 || H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned({dz, w, dx})) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int U = pool ? 2 : 1, Hd = H / U * U, Wd = W / U * U;
  const auto is = [&](int KH, int CI, int CO, bool POOL) {
    return kh == KH && kw == KH && Ci == CI && Co == CO && (pool != 0) == POOL;
  };
  // the dgrad's geometry: Co in, Ci out, unpooled, top/left pad k-1-(k-1)/2;
  // warpgroups a CTA as measured best on an H100 (PERF.md): three for
  // blocks 1-2, two for block 3's samples of two 64-position tiles
  const auto dgrad = [&](auto geom, auto wgs) {
    using G = decltype(geom);
    return launch_dgrad<G, decltype(wgs)::value>(dz, w, dx, B, H, W, Hd, Wd, s);
  };
  using Two = std::integral_constant<int, 2>;
  using Three = std::integral_constant<int, 3>;
  if (is(5, 32, 32, true)) return dgrad(Geom<5, 5, 32, 32, false, 2, 2>{}, Three{});
  if (is(4, 32, 64, true)) return dgrad(Geom<4, 4, 64, 32, false, 2, 2>{}, Three{});
  if (is(3, 64, 64, false)) return dgrad(Geom<3, 3, 64, 64, false, 1, 1>{}, Two{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// (c) dw [kh, kw, Ci, Co] and db [Co] bf16 from x (the forward's input), dz
// and the route's db partials. part: f32 scratch of part_cap partials of
// KP x Co (KP = kh * kw * Ci, or kh * 32 for Ci = 4), one a cluster of
// kClusterCtas CTAs.
extern "C" int ba3c_conv_block_wgrad(const void* x, int x_uint8, const void* dz,
                                     const void* dbpart, int n_dbpart, void* part,
                                     int part_cap, void* dw, void* db, int B, int H,
                                     int W, int Ci, int Co, int kh, int kw, int pool,
                                     float scale, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || n_dbpart < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (misaligned({x, dz, dbpart, part, dw})) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int U = pool ? 2 : 1, Hd = H / U * U, Wd = W / U * U;
  if (Hd == 0 || Wd == 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto is = [&](int KH, int CI, int CO, bool POOL) {
    return kh == KH && kw == KH && Ci == CI && Co == CO && (pool != 0) == POOL;
  };
  const auto wgrad = [&](auto geom, auto in) {
    using G = decltype(geom);
    using TIn = decltype(in);
    return launch_wgrad<G, TIn>(x, dz, dbpart, n_dbpart, part, part_cap, dw, db, B, H, W,
                                Hd, Wd, scale, s);
  };
  if (is(5, 4, 32, true)) {
    using G = Geom<5, 5, 4, 32, false>;
    return x_uint8 ? wgrad(G{}, uint8_t{}) : wgrad(G{}, bf16{});
  }
  if (x_uint8) return static_cast<int>(cudaErrorInvalidValue);
  if (is(5, 32, 32, true)) return wgrad(Geom<5, 5, 32, 32, false>{}, bf16{});
  if (is(4, 32, 64, true)) return wgrad(Geom<4, 4, 32, 64, false>{}, bf16{});
  if (is(3, 64, 64, false)) return wgrad(Geom<3, 3, 64, 64, false>{}, bf16{});
  return static_cast<int>(cudaErrorInvalidValue);
}
