// The forward BA3C conv block's implicit-GEMM kernel (conv_block.cu's
// header describes the design): the geometry, the halo loader, the
// mainloop and its epilogue, and the launch with its band-height cost
// model. conv_block_bwd.cu includes it for Geom, the shared-memory and
// tensor-core helpers, pre_act and device_info; the backward's kernels
// are its own.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <mutex>
#include <tuple>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDevices = 64;

// PH_, PW_: the top and left zero pad. The forward's is SAME's (k - 1) / 2;
// the dgrad, a conv of dz with the flipped weights, pads k - 1 - (k - 1) / 2
template <int KH_, int KW_, int CI_, int CO_, bool POOL_, int PH_ = (KH_ - 1) / 2,
          int PW_ = (KW_ - 1) / 2>
struct Geom {
  static constexpr int KH = KH_, KW = KW_, CI = CI_, CO = CO_;
  static constexpr bool POOL = POOL_;
  static constexpr int U = POOL ? 2 : 1;  // pre-pool rows (cols) per output
  static constexpr int PH = PH_, PW = PW_;
  // K by kernel rows (Ci = 4), else by taps of 16 channels
  static constexpr bool ROW = CI % 16 != 0;
  static constexpr int KROW = (KW * CI + 15) / 16 * 16;
  static constexpr int KP = ROW ? KH * KROW : KH * KW * CI;  // padded K
  // halo pixels read right of a kernel row's last tap (row mode)
  static constexpr int EXTRA = ROW ? (KROW - KW * CI + CI - 1) / CI : 0;
  // pooled ldmatrix A: the halo split by row and column parity (header)
  static constexpr bool SPLIT = POOL && !ROW;
  static constexpr int CS = ROW ? CI : ((CI / 8) % 2 ? CI : CI + 8);
  static constexpr int WS = (CO / 8) % 2 ? CO : CO + 8;
  static constexpr int UPC = POOL ? 8 : 32;  // output units per warp chunk
  static constexpr int NJ = CO / 8;          // n8 fragments
  static_assert(CO % 16 == 0, "Co must be a multiple of 16");
  static_assert(!ROW || (CI % 2 == 0 && 16 % CI == 0), "row mode takes Ci 2, 4, 8");

  static __host__ __device__ int halo_cols(int W) { return W + KW - 1 + EXTRA; }
  // slots per halo row: at least halo_cols, and equal to W / U mod 8
  static __host__ __device__ int halo_pitch(int W) {
    const int c = halo_cols(W);
    return c + ((W / U - c) & 7);
  }
  // the slot of halo pixel (hr, hc). Split: the even rows, then the odd
  // ones from `plane`; in a row, the even columns, then the odd ones
  static __device__ __forceinline__ int slot(int hr, int hc, int pitch, int plane) {
    if constexpr (SPLIT) {
      return (hr & 1) * plane + (hr >> 1) * pitch + (hc & 1) * ((pitch + 1) >> 1) +
             (hc >> 1);
    } else {
      return hr * pitch + hc;
    }
  }
  static size_t smem_bytes(int W, int R) {
    return CO * 4 + size_t(KP) * WS * 2 +
           size_t(R * U + KH - 1) * halo_pitch(W) * CS * 2;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// BYTES from global to shared, or zeros when !valid (src is then not read)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(BYTES), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// VEC input channels of one pixel into the halo: bf16 is copied as it is
template <int VEC>
__device__ __forceinline__ void copy_in(bf16* dst, const bf16* src, bool valid,
                                        float /*scale*/) {
  cp_async<VEC * 2>(dst, src, valid);
}

// uint8 -> bf16 (exact) times bf16(1/255): the f32 product of two bf16
// values is exact, so one rounding to bf16 is the bf16 multiply
template <int VEC>
__device__ __forceinline__ void copy_in(bf16* dst, const uint8_t* src,
                                        bool valid, float scale) {
  static_assert(VEC == 4, "uint8 pixels are copied 4 bytes at a time");
  const uint32_t in = valid ? __ldg(reinterpret_cast<const unsigned int*>(src)) : 0u;
  uint32_t out[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t word = in >> (16 * i);
    out[i] = pack_bf16x2(static_cast<float>(word & 0xff) * scale,
                         static_cast<float>((word >> 8) & 0xff) * scale);
  }
  *reinterpret_cast<uint2*>(dst) = make_uint2(out[0], out[1]);
}

// The input rows iy0 .. iy0 + nrows - 1 of one sample of an H x W image,
// columns -PW .. -PW + hwc - 1, into the halo's slots of CS channels, zero
// outside the image.
template <class G, typename TIn>
__device__ __forceinline__ void load_halo(const TIn* __restrict__ xb, bf16* hs,
                                          int H, int W, int iy0, int nrows,
                                          int hwc, int pitch, int plane,
                                          float scale, int nthreads = kThreads) {
  constexpr int VEC = G::CI < 8 ? G::CI : 8;  // channels per copy
  constexpr int NV = G::CI / VEC;
  const int n = nrows * hwc * NV;
  for (int i = threadIdx.x; i < n; i += nthreads) {
    const int p = i / NV, v = i - p * NV;
    const int hr = p / hwc, hc = p - hr * hwc;
    const int iy = iy0 + hr, ix = hc - G::PW;
    const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
    const size_t src = in ? (size_t(iy) * W + ix) * G::CI + v * VEC : 0;
    copy_in<VEC>(hs + G::slot(hr, hc, pitch, plane) * G::CS + v * VEC, xb + src,
                 in, scale);
  }
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// the pre-activation z = bf16(bf16(acc) + b): the sum rounded, then the
// bf16 bias add
__device__ __forceinline__ float pre_act(float acc, float bias) {
  return bf16_round(bf16_round(acc) + bias);
}

__device__ __forceinline__ float bias_relu(float acc, float bias) {
  return fmaxf(pre_act(acc, bias), 0.f);
}

// One warp: output units u0 .. u0 + UPC - 1 of the band (those < units),
// into yb, the band's output.
template <class G>
__device__ __forceinline__ void conv_chunk(const bf16* ws, const bf16* hs,
                                           const float* bias,
                                           bf16* __restrict__ yb, int u0,
                                           int units, int WO, int pitch,
                                           int plane) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[2][G::NJ][4];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < G::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][j][e] = 0.f;

  // the halo slot of row `row` (0-15) of m fragment f at tap (0, par).
  // Pooled: row & 7 is the window, row >> 3 its column and f its row, so
  // that the thread with rows g and g + 8 of both fragments holds a whole
  // window. Else the 32 rows are 32 consecutive positions. Rows past the
  // band repeat u0.
  auto pos = [&](int f, int row, int par) {
    int u = G::POOL ? u0 + (row & 7) : u0 + f * 16 + row;
    if (u >= units) u = u0;
    const int uy = u / WO, ux = u - uy * WO;
    return G::POOL ? G::slot(2 * uy + f, 2 * ux + (row >> 3) + par, pitch, plane)
                   : G::slot(uy, ux, pitch, plane);
  };
  // B (the weights, [K][WS]) through ldmatrix.trans: lanes 0-15 give the
  // 16 k rows of n 0-7, lanes 16-31 those of n 8-15
  const uint32_t bw =
      smem_u32(ws) + (((lane & 7) + ((lane >> 3) & 1) * 8) * G::WS + (lane >> 4) * 8) * 2;

  if constexpr (!G::ROW) {
    // A through ldmatrix: lane l gives row l & 15, channels (l >> 4) * 8.
    // a[f][par] is tap (0, par) of fragment f. Split, tap (ky, kx) of f is
    // a[(f + ky) & 1][kx & 1] plus (f + ky) >> 1 rows and kx >> 1 slots;
    // else a[f][0] plus ky rows and kx slots
    constexpr int SLOT = G::CS * 2;
    uint32_t a[2][2];
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int par = 0; par < 2; ++par)
        a[f][par] = smem_u32(hs) +
                    (pos(f, lane & 15, G::SPLIT ? par : 0) * G::CS + (lane >> 4) * 8) * 2;
#pragma unroll
    for (int ky = 0; ky < G::KH; ++ky) {
#pragma unroll
      for (int kx = 0; kx < G::KW; ++kx) {
#pragma unroll
        for (int c = 0; c < G::CI / 16; ++c) {
          uint32_t fa[2][4];
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            const int q = f + ky;
            const uint32_t at =
                G::SPLIT ? a[q & 1][kx & 1] + ((q >> 1) * pitch + (kx >> 1)) * SLOT
                         : a[f][0] + (ky * pitch + kx) * SLOT;
            ldsm_x4(fa[f], at + c * 32);
          }
          const int k0 = (ky * G::KW + kx) * G::CI + c * 16;
#pragma unroll
          for (int jj = 0; jj < G::NJ / 2; ++jj) {
            uint32_t fb[4];
            ldsm_x4_trans(fb, bw + (k0 * G::WS + jj * 16) * 2);
#pragma unroll
            for (int f = 0; f < 2; ++f) {
              mma_bf16(acc[f][2 * jj], fa[f], fb[0], fb[1]);
              mma_bf16(acc[f][2 * jj + 1], fa[f], fb[2], fb[3]);
            }
          }
        }
      }
    }
  } else {
    // A from 32-bit loads: rows g (p[f][0]) and g + 8 (p[f][1]), k 2t, 2t+1
    const bf16* p[2][2];
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h) p[f][h] = hs + pos(f, g + 8 * h, 0) * G::CS + 2 * t;
#pragma unroll
    for (int ky = 0; ky < G::KH; ++ky) {
#pragma unroll
      for (int kk = 0; kk < G::KROW / 16; ++kk) {
        const int eo = ky * pitch * G::CS + kk * 16;
        uint32_t fa[2][4];
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          fa[f][0] = *reinterpret_cast<const uint32_t*>(p[f][0] + eo);
          fa[f][1] = *reinterpret_cast<const uint32_t*>(p[f][1] + eo);
          fa[f][2] = *reinterpret_cast<const uint32_t*>(p[f][0] + eo + 8);
          fa[f][3] = *reinterpret_cast<const uint32_t*>(p[f][1] + eo + 8);
        }
        const int k0 = ky * G::KROW + kk * 16;
#pragma unroll
        for (int jj = 0; jj < G::NJ / 2; ++jj) {
          uint32_t fb[4];
          ldsm_x4_trans(fb, bw + (k0 * G::WS + jj * 16) * 2);
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            mma_bf16(acc[f][2 * jj], fa[f], fb[0], fb[1]);
            mma_bf16(acc[f][2 * jj + 1], fa[f], fb[2], fb[3]);
          }
        }
      }
    }
  }

  // epilogue; the thread holds channels 8j + 2t, 8j + 2t + 1 of rows g
  // (acc[..][0..1]) and g + 8 (acc[..][2..3]). Pooled, acc[f][j][2h + e]
  // is window row f, column h, channel 8j + 2t + e of window u0 + g
#pragma unroll
  for (int j = 0; j < G::NJ; ++j) {
    const int co = 8 * j + 2 * t;
    if constexpr (G::POOL) {
      const float bj[2] = {bias[co], bias[co + 1]};
      const int u = u0 + g;
      if (u < units) {
        // every candidate is a relu output (>= 0), so 0 is the max's identity
        float m0 = 0.f, m1 = 0.f;
#pragma unroll
        for (int f = 0; f < 2; ++f) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            m0 = fmaxf(m0, bias_relu(acc[f][j][2 * h], bj[0]));
            m1 = fmaxf(m1, bias_relu(acc[f][j][2 * h + 1], bj[1]));
          }
        }
        *reinterpret_cast<uint32_t*>(yb + size_t(u) * G::CO + co) = pack_bf16x2(m0, m1);
      }
    } else {
      const float bj[2] = {bias[co], bias[co + 1]};
#pragma unroll
      for (int f = 0; f < 2; ++f) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int u = u0 + f * 16 + h * 8 + g;
          if (u < units) {
            *reinterpret_cast<uint32_t*>(yb + size_t(u) * G::CO + co) =
                pack_bf16x2(bias_relu(acc[f][j][2 * h], bj[0]),
                            bias_relu(acc[f][j][2 * h + 1], bj[1]));
          }
        }
      }
    }
  }
}

// Grid-stride over work items (sample, band of R output rows); NB bands a
// sample. The conv's output grid is H x W (before the pool). Shared memory:
// bias [CO] f32, weights [KP][WS], halo.
template <class G, typename TIn>
__global__ void __launch_bounds__(kThreads)
    conv_block_kernel(const TIn* __restrict__ x, const bf16* __restrict__ w,
                      const bf16* __restrict__ b, bf16* __restrict__ y, int B,
                      int H, int W, int R, int NB, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* bias = reinterpret_cast<float*>(smem);
  bf16* ws = reinterpret_cast<bf16*>(smem + G::CO * 4);
  bf16* hs = ws + G::KP * G::WS;
  const int HO = H / G::U, WO = W / G::U;
  const int hwc = G::halo_cols(W), pitch = G::halo_pitch(W);

  for (int i = threadIdx.x; i < G::CO; i += kThreads) bias[i] = __bfloat162float(b[i]);
  // the weights once per CTA, waited for with the first halo; row mode
  // pads each kernel row's kw*Ci values to KROW with zeros
  constexpr int WV = G::CO / 8;
  for (int i = threadIdx.x; i < G::KP * WV; i += kThreads) {
    const int kp = i / WV, v = i - kp * WV;
    int src = kp;
    bool valid = true;
    if constexpr (G::ROW) {
      const int ky = kp / G::KROW, j = kp - ky * G::KROW;
      valid = j < G::KW * G::CI;
      src = valid ? ky * G::KW * G::CI + j : 0;
    }
    cp_async<16>(ws + kp * G::WS + v * 8, w + size_t(src) * G::CO + v * 8, valid);
  }

  const int n_items = B * NB;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int bi = item / NB, r0 = (item - bi * NB) * R;
    const int rows = min(R, HO - r0);
    const int units = rows * WO;
    const int nrows = rows * G::U + G::KH - 1;
    const int plane = ((nrows + 1) >> 1) * pitch;  // where split odd rows start
    __syncthreads();  // the previous item's reads of the halo are done
    load_halo<G>(x + size_t(bi) * H * W * G::CI, hs, H, W, r0 * G::U - G::PH, nrows, hwc,
                 pitch, plane, scale);
    cp_async_wait_all();
    __syncthreads();
    bf16* yb = y + (size_t(bi) * HO + r0) * WO * G::CO;
    const int nchunks = (units + G::UPC - 1) / G::UPC;
    for (int c = threadIdx.x >> 5; c < nchunks; c += kWarps) {
      conv_chunk<G>(ws, hs, bias, yb, c * G::UPC, units, WO, pitch, plane);
    }
  }
}

struct DeviceInfo {
  int sms = 0, smem_block = 0, smem_sm = 0, ctas_by_regs = 0;
};

// Once per kernel (named by Tag) and device: the SM count, the shared
// memory limits, the opt-in to all of a block's, and how many CTAs of
// `threads` fit on an SM by registers.
template <class Tag, class Kernel>
int device_info(Kernel kernel, int threads, DeviceInfo* out) {
  static std::atomic<bool> ready[kMaxDevices];
  static DeviceInfo info[kMaxDevices];
  static std::mutex mu;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev].load(std::memory_order_acquire)) {
    std::lock_guard<std::mutex> lock(mu);
    if (!ready[dev].load(std::memory_order_relaxed)) {
      DeviceInfo d;
      if ((e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev)) ||
          (e = cudaDeviceGetAttribute(&d.smem_block,
                                      cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) ||
          (e = cudaDeviceGetAttribute(&d.smem_sm,
                                      cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev)) ||
          (e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    d.smem_block)) ||
          (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&d.ctas_by_regs, kernel,
                                                             threads, 0))) {
        return static_cast<int>(e);
      }
      info[dev] = d;
      ready[dev].store(true, std::memory_order_release);
    }
  }
  *out = info[dev];
  return 0;
}

// The launch: picks the band height R that minimises a cost model (whole
// warp rounds per band plus a halo load, spread over the CTAs that fit on
// the card, never below one band's time), then launches one CTA per
// resident slot or per item, whichever is fewer.
template <class G, typename TIn>
int launch(const void* x, const void* w, const void* b, void* y, int B, int H, int W,
           float scale, cudaStream_t stream) {
  const auto kernel = conv_block_kernel<G, TIn>;
  DeviceInfo d;
  using Tag = std::tuple<G, TIn>;
  if (const int e = device_info<Tag>(kernel, kThreads, &d)) return e;

  const int HO = H / G::U, WO = W / G::U;
  if (HO == 0 || WO == 0) return 0;
  auto band_cost = [&](int rows) {
    const int chunks = (rows * WO + G::UPC - 1) / G::UPC;
    return (chunks + kWarps - 1) / kWarps + 0.25;
  };
  int best_r = 0, best_slots = 0;
  double best = 0.0;
  for (int R = 1; R <= HO; ++R) {
    const size_t smem = G::smem_bytes(W, R);
    if (smem > size_t(d.smem_block)) break;
    const int per_sm = std::min<long long>(d.ctas_by_regs, d.smem_sm / (smem + 1024));
    if (per_sm < 1) break;
    const int NB = (HO + R - 1) / R;
    const double full = band_cost(R), last = band_cost(HO - (NB - 1) * R);
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
  const int NB = (HO + best_r - 1) / best_r;
  const long long items = static_cast<long long>(B) * NB;
  if (items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = std::min<long long>(items, best_slots);
  kernel<<<static_cast<int>(grid), kThreads, G::smem_bytes(W, best_r), stream>>>(
      static_cast<const TIn*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(b),
      static_cast<bf16*>(y), B, H, W, best_r, NB, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
