// The backward of the BA3C conv block for Hopper (sm_90a): three launches
// per block, each a hand-written tensor-core kernel.
//
// Replaces distributed_ba3c_tpu/ops/pallas_conv.py:_cb_bwd (lines 351-356),
// the custom VJP's backward, which recomputes reference_block in XLA and
// takes its VJP; its docstring's Pallas design ("unpool-scatter + packed
// dW/dx GEMMs") was never built there. With g the bf16 cotangent of
// y = maxpool2x2?(relu(z)), z = bf16(bf16(acc) + b), acc = conv_SAME(x, W):
//
//  (a) route (ba3c_conv_block_route): the forward's mainloop (conv_block.cuh)
//      recomputes acc with the forward's own sums, so z is bit-identical to
//      the forward's, and a second epilogue routes g back through the pool
//      and the relu in registers: the pooled layout puts a whole window in
//      one thread's accumulators. It writes dz, the cotangent of acc, at
//      pre-pool resolution [B, U*Ho, U*Wo, Co] (block 2's 21st pre-pool row
//      and column are never formed: dz has 20 x 20, and the readers take
//      what lies outside as 0), and each CTA's f32 sums of dz (db partials).
//      Tie rules: reference_block's (relu'(0) = 1/2; the nested max splits
//      a tie evenly: the column pair of each window row, then the rows) or
//      flax's (relu'(0) = 0; a window's whole cotangent to its first
//      maximum, row-major). dz is g times 0, 1/8, 1/4, 1/2 or 1: exact.
//  (b) dgrad (ba3c_conv_block_dgrad), blocks 1-3: dx = conv(dz, W flipped
//      in both taps, in and out swapped), the same implicit GEMM as the
//      forward with the pads swapped (top/left k - 1 - (k - 1) / 2), dz's
//      grid as the input and the forward's input grid as the output, and a
//      plain epilogue: the f32 sums rounded to bf16.
//  (c) wgrad (ba3c_conv_block_wgrad): dw[ky, kx, ci, co] = sum over b, y, x
//      of xpad[b, y + ky - ph, x + kx - pw, ci] * dz[b, y, x, co], a GEMM of
//      [K = kh*kw*Ci] x [Co] reducing over the B * Hd * Wd positions of dz
//      (18M for block 0 at B=2560). Both operands sit position-major in
//      shared memory (the x halo of a band, the band's dz tile), and
//      ldmatrix.trans turns both into mma.sync m16n8k16 fragments: A[k,
//      position] from the halo, B[position, co] from the dz tile. Block 0's
//      Ci = 4 puts 2 pixels in 8 bf16, so its halo holds pixel pairs (slot
//      c = pixels c, c + 1), every one 16-byte aligned, and K runs by kernel
//      rows padded to 32 as in the forward. A warp holds 64 (Co = 32) or 32
//      (Co = 64) K rows x Co accumulators; the K fragments are split across
//      the warps of a CTA and across KG CTAs, the positions across P CTAs
//      (bands of dz rows, grid-strided). Each CTA writes its f32 partial
//      [K rows, Co] to scratch, and a second kernel adds the P partials of
//      every element in a fixed order, adds the route's db partials the same
//      way and rounds both to bf16: no float atomics, so the gradients are
//      bit-identical from run to run.
//
// What bounds each piece on an H100 (chip_smoke.py counts each input read
// once and each output written once, the operations at 989 TFLOP/s dense
// bf16, the bytes at 3.35 TB/s): the route moves x, g and dz and does the
// forward's products, so block 0 (dz 1.16 GB at B=2560) is bound by bytes,
// blocks 1-2 by operations; the dgrad and wgrad do the same products as
// the forward over dz, bound by operations except on block 3. The design
// keeps every re-read of x, dz and the weights in shared memory and moves
// the products to the tensor cores. Left for later: wgmma and TMA, a
// double-buffered halo, fusing the route into the wgrad (dz would then
// never reach device memory), and a route that writes dz with 16-byte
// stores.
//
// Instantiated for the four BA3C blocks, at any H and W, as the forward
// (ops/conv_block.py: KERNEL_GEOMETRIES; the dgrad for blocks 1-3 only,
// DGRAD_GEOMETRIES). Any other geometry returns cudaErrorInvalidValue.

#include <initializer_list>

#include "conv_block.cuh"

namespace {

// the most wgrad CTAs per SM the band height is chosen for (the wrapper
// allocates this many partials per SM)
constexpr int kWgradCtasPerSm = 4;

// The wgrad's split of one geometry (G: the forward's geometry unpooled,
// whose positions are dz's). SS bf16 per halo slot: a pixel pair in row
// mode, else the forward's padded channel stride.
template <class G>
struct WGeom {
  static constexpr int SS = G::ROW ? 8 : G::CS;
  // A: the second 8 rows of a 16-row m fragment lie 8 channels on, or in
  // row mode 2 pixels (one pair slot of 8 is 2 pixels x 4 channels)
  static constexpr int MH = G::ROW ? 16 : 8;
  static constexpr int MF = G::CO == 32 ? 4 : 2;  // m16 fragments per warp
  static constexpr int NF = G::KP / 16;           // m16 fragments of K
  static constexpr int NEED = (NF + MF - 1) / MF;  // warps over all of K
  static constexpr int KG = (NEED + 7) / 8;        // CTAs along K
  static constexpr int WARPS = (NEED + KG - 1) / KG;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int DS = G::WS;  // dz tile row stride (bank-conflict free)
  static_assert(G::ROW ? G::CI == 4 && G::KROW == 32 : G::CI % 16 == 0,
                "wgrad takes Ci = 4 (pixel pairs) or a multiple of 16");

  static __host__ __device__ int tile_rows(int Wd, int R) { return (R * Wd + 15) / 16 * 16; }
  static size_t smem_bytes(int Wd, int R) {
    return size_t(tile_rows(Wd, R)) * DS * 2 +
           size_t(R + G::KH - 1) * G::halo_pitch(Wd) * SS * 2;
  }
};

// Row mode: the pixel pairs (iy0 + hr, hc - PW + {0, 1}) into slot (hr, hc)
template <class G, typename TIn>
__device__ __forceinline__ void load_pair_halo(const TIn* __restrict__ xb, bf16* hs,
                                               int H, int W, int iy0, int nrows,
                                               int hwc, int pitch, float scale,
                                               int nthreads) {
  const int n = nrows * hwc * 2;
  for (int i = threadIdx.x; i < n; i += nthreads) {
    const int p = i >> 1, half = i & 1;
    const int hr = p / hwc, hc = p - hr * hwc;
    const int iy = iy0 + hr, ix = hc - G::PW + half;
    const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
    const size_t src = in ? (size_t(iy) * W + ix) * 4 : 0;
    copy_in<4>(hs + (hr * pitch + hc) * 8 + half * 4, xb + src, in, scale);
  }
}

// CTA (kg, ps) = (blockIdx.x % KG, blockIdx.x / KG): K fragments
// (kg * WARPS + warp) * MF .. + MF - 1 of each warp, over the items
// (sample, band of R dz rows) ps, ps + P, ...; its f32 sums go to
// part[ps][kp][co]. x is [B, H, W, CI], dz [B, Hd, Wd, CO].
template <class G, typename TIn>
__global__ void __launch_bounds__(WGeom<G>::THREADS)
    wgrad_kernel(const TIn* __restrict__ x, const bf16* __restrict__ dz,
                 float* __restrict__ part, int B, int H, int W, int Hd, int Wd, int R,
                 int NB, int P, float scale) {
  using WG = WGeom<G>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* dzs = reinterpret_cast<bf16*>(smem);
  bf16* hs = dzs + WG::tile_rows(Wd, R) * WG::DS;
  const int kg = blockIdx.x % WG::KG, ps = blockIdx.x / WG::KG;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2,
            t = lane & 3;
  const int mf0 = (kg * WG::WARPS + warp) * WG::MF;
  const int hwc = G::halo_cols(Wd), pitch = G::halo_pitch(Wd);

  // each fragment's tap, as a byte offset in the halo from a position's slot
  uint32_t toff[WG::MF];
#pragma unroll
  for (int i = 0; i < WG::MF; ++i) {
    const int mf = min(mf0 + i, WG::NF - 1);
    if constexpr (G::ROW) {
      toff[i] = (((mf >> 1) * pitch + (mf & 1) * 4) * WG::SS) * 2;
    } else {
      const int tap = mf * 16 / G::CI, c = mf * 16 - tap * G::CI;
      const int ky = tap / G::KW, kx = tap - ky * G::KW;
      toff[i] = ((ky * pitch + kx) * WG::SS + c) * 2;
    }
  }
  // B (dz, [position][DS]) through ldmatrix.trans, as the forward's weights
  const uint32_t bw = smem_u32(dzs) +
                      (((lane & 7) + ((lane >> 3) & 1) * 8) * WG::DS + (lane >> 4) * 8) * 2;

  float acc[WG::MF][G::NJ][4];
#pragma unroll
  for (int i = 0; i < WG::MF; ++i)
#pragma unroll
    for (int j = 0; j < G::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int n_items = B * NB;
  for (int item = ps; item < n_items; item += P) {
    const int bi = item / NB, r0 = (item - bi * NB) * R;
    const int rows = min(R, Hd - r0);
    const int units = rows * Wd;
    __syncthreads();  // the previous item's reads of the tiles are done
    if constexpr (G::ROW) {
      load_pair_halo<G>(x + size_t(bi) * H * W * G::CI, hs, H, W, r0 - G::PH,
                        rows + G::KH - 1, hwc, pitch, scale, WG::THREADS);
    } else {
      load_halo<G>(x + size_t(bi) * H * W * G::CI, hs, H, W, r0 - G::PH, rows + G::KH - 1,
                   hwc, pitch, 0, scale, WG::THREADS);
    }
    // the band's dz, zero past its last position up to a whole k16 step
    constexpr int DV = G::CO / 8;
    const bf16* dzb = dz + (size_t(bi) * Hd + r0) * Wd * G::CO;
    const int n_dz = WG::tile_rows(Wd, rows) * DV;
    for (int i = threadIdx.x; i < n_dz; i += WG::THREADS) {
      const int u = i / DV, v = i - u * DV;
      const bool in = u < units;
      cp_async<16>(dzs + u * WG::DS + v * 8, dzb + (in ? size_t(u) * G::CO + v * 8 : 0), in);
    }
    cp_async_wait_all();
    __syncthreads();
    if (mf0 < WG::NF) {
      for (int u0 = 0; u0 < units; u0 += 16) {
        uint32_t fb[G::NJ / 2][4];
#pragma unroll
        for (int jj = 0; jj < G::NJ / 2; ++jj)
          ldsm_x4_trans(fb[jj], bw + (u0 * WG::DS + jj * 16) * 2);
        // A: lane l gives position u0 + (l >> 4) * 8 + (l & 7) (positions
        // past the band repeat its last; their dz is 0), rows (l >> 3) & 1
        // of the fragment's two 8-row halves
        const int u = min(u0 + (lane >> 4) * 8 + (lane & 7), units - 1);
        const int py = u / Wd, px = u - py * Wd;
        const uint32_t at =
            smem_u32(hs) + ((py * pitch + px) * WG::SS + ((lane >> 3) & 1) * WG::MH) * 2;
#pragma unroll
        for (int i = 0; i < WG::MF; ++i) {
          if (mf0 + i < WG::NF) {
            uint32_t fa[4];
            ldsm_x4_trans(fa, at + toff[i]);
#pragma unroll
            for (int jj = 0; jj < G::NJ / 2; ++jj) {
              mma_bf16(acc[i][2 * jj], fa, fb[jj][0], fb[jj][1]);
              mma_bf16(acc[i][2 * jj + 1], fa, fb[jj][2], fb[jj][3]);
            }
          }
        }
      }
    }
  }

  // the partial: rows kp = mf * 16 + g (+ 8) of each fragment, channels
  // 8j + 2t, 8j + 2t + 1
#pragma unroll
  for (int i = 0; i < WG::MF; ++i) {
    if (mf0 + i >= WG::NF) continue;
#pragma unroll
    for (int j = 0; j < G::NJ; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kp = (mf0 + i) * 16 + g + 8 * h;
        *reinterpret_cast<float2*>(part + (size_t(ps) * G::KP + kp) * G::CO + 8 * j + 2 * t) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

// dw (HWIO) = bf16 of the P partials summed in order; row mode maps each
// real k = (ky * KW + kx) * CI + ci to its padded row ky * KROW + kx * CI +
// ci. db = bf16 of the route's n_dbpart partials summed in order.
template <class G>
__global__ void wgrad_reduce_kernel(const float* __restrict__ part, int P,
                                    const float* __restrict__ dbpart, int n_dbpart,
                                    bf16* __restrict__ dw, bf16* __restrict__ db) {
  constexpr int K = G::KH * G::KW * G::CI;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < K * G::CO) {
    const int k = i / G::CO, co = i - k * G::CO;
    int kp = k;
    if constexpr (G::ROW) {
      const int ky = k / (G::KW * G::CI);
      kp = ky * G::KROW + (k - ky * G::KW * G::CI);
    }
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += part[(size_t(p) * G::KP + kp) * G::CO + co];
    dw[i] = __float2bfloat16(s);
  } else if (i < K * G::CO + G::CO) {
    const int co = i - K * G::CO;
    float s = 0.f;
    for (int p = 0; p < n_dbpart; ++p) s += dbpart[size_t(p) * G::CO + co];
    db[co] = __float2bfloat16(s);
  }
}

// The band: the tallest R at which as many CTAs fit on an SM as registers
// allow, at most kWgradCtasPerSm (at least 1 row): a CTA loads its band and
// then computes, so the SM overlaps one CTA's loads with another's
// products (block 0, 3 warps a CTA: 1.89 -> 1.15 ms at B=2560 on an H100
// against the tallest band at which 2 fit; PERF.md). The position split P:
// the CTAs that fit on the card over the KG along K, at most part_cap and
// the items.
template <class G, typename TIn>
int launch_wgrad(const void* x, const void* dz, const void* dbpart, int n_dbpart,
                 void* part, int part_cap, void* dw, void* db, int B, int H, int W,
                 int Hd, int Wd, float scale, cudaStream_t stream) {
  using WG = WGeom<G>;
  const auto kernel = wgrad_kernel<G, TIn>;
  DeviceInfo d;
  using Tag = std::tuple<G, TIn, std::integral_constant<int, -1>>;
  if (const int e = device_info<Tag>(kernel, WG::THREADS, &d)) return e;
  int R = 0;
  const int target = std::max(1, std::min(d.ctas_by_regs, kWgradCtasPerSm));
  for (int r = 1; r <= Hd; ++r) {
    const size_t smem = WG::smem_bytes(Wd, r);
    if (smem > size_t(d.smem_block) || target * (smem + 1024) > size_t(d.smem_sm)) break;
    R = r;
  }
  if (R == 0) {
    if (WG::smem_bytes(Wd, 1) > size_t(d.smem_block)) return static_cast<int>(cudaErrorInvalidValue);
    R = 1;
  }
  const size_t smem = WG::smem_bytes(Wd, R);
  const int NB = (Hd + R - 1) / R;
  const long long items = static_cast<long long>(B) * NB;
  if (items > 0x7fffffff || part_cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int per_sm = std::max<long long>(
      1, std::min<long long>(d.ctas_by_regs, d.smem_sm / (smem + 1024)));
  const long long P = std::min<long long>(
      {static_cast<long long>(part_cap), std::max(1, per_sm * d.sms / WG::KG), items});
  kernel<<<static_cast<int>(WG::KG * P), WG::THREADS, smem, stream>>>(
      static_cast<const TIn*>(x), static_cast<const bf16*>(dz), static_cast<float*>(part), B,
      H, W, Hd, Wd, R, NB, static_cast<int>(P), scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int n = G::KH * G::KW * G::CI * G::CO + G::CO;
  wgrad_reduce_kernel<G><<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<int>(P),
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
  const RouteArgs rt{static_cast<const bf16*>(g), static_cast<bf16*>(dz),
                     static_cast<float*>(dbpart), flax != 0};
  const auto is = [&](int KH, int CI, int CO, bool POOL) {
    return kh == KH && kw == KH && Ci == CI && Co == CO && (pool != 0) == POOL;
  };
  const auto route = [&](auto geom, auto in) {
    using G = decltype(geom);
    using TIn = decltype(in);
    return launch<G, TIn, kRoute>(x, w, b, nullptr, B, H, W, H, W, scale, rt, dbpart_cap,
                                  n_dbpart, s);
  };
  if (is(5, 4, 32, true)) {
    using G = Geom<5, 5, 4, 32, true>;
    return x_uint8 ? route(G{}, uint8_t{}) : route(G{}, bf16{});
  }
  if (x_uint8) return static_cast<int>(cudaErrorInvalidValue);
  if (is(5, 32, 32, true)) return route(Geom<5, 5, 32, 32, true>{}, bf16{});
  if (is(4, 32, 64, true)) return route(Geom<4, 4, 32, 64, true>{}, bf16{});
  if (is(3, 64, 64, false)) return route(Geom<3, 3, 64, 64, false>{}, bf16{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// (b) dx [B, H, W, Ci] bf16 from dz and wt [kh, kw, Co, Ci], the forward's
// HWIO weight flipped in ky and kx with Ci and Co swapped. Blocks 1-3.
extern "C" int ba3c_conv_block_dgrad(const void* dz, const void* wt, void* dx, int B,
                                     int H, int W, int Ci, int Co, int kh, int kw,
                                     int pool, void* stream) {
  if (B == 0) return 0;
  if (B < 0 || H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned({dz, wt, dx})) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int U = pool ? 2 : 1, Hd = H / U * U, Wd = W / U * U;
  const auto is = [&](int KH, int CI, int CO, bool POOL) {
    return kh == KH && kw == KH && Ci == CI && Co == CO && (pool != 0) == POOL;
  };
  // the dgrad's geometry: Co in, Ci out, unpooled, top/left pad k-1-(k-1)/2
  const auto dgrad = [&](auto geom) {
    using G = decltype(geom);
    return launch<G, bf16, kStore>(dz, wt, nullptr, dx, B, H, W, Hd, Wd, 1.f, RouteArgs{}, 0,
                                   nullptr, s);
  };
  if (is(5, 32, 32, true)) return dgrad(Geom<5, 5, 32, 32, false, 2, 2>{});
  if (is(4, 32, 64, true)) return dgrad(Geom<4, 4, 64, 32, false, 2, 2>{});
  if (is(3, 64, 64, false)) return dgrad(Geom<3, 3, 64, 64, false, 1, 1>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// (c) dw [kh, kw, Ci, Co] and db [Co] bf16 from x (the forward's input), dz
// and the route's db partials. part: f32 scratch of part_cap partitions of
// KP x Co (KP = kh * kw * Ci, or kh * 32 for Ci = 4).
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
