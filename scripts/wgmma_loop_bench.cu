// The conv-block backward's inner loop alone, on one Hopper card: how fast
// can a warpgroup run k16 steps of wgmma.m64n32k16 (bf16, f32 accumulate)
// when A comes from registers (constant, or loaded by ldmatrix one or two
// steps ahead), from shared memory through a descriptor, or as mma.sync,
// at 1-3 warpgroups a CTA and 1 or 4 tiles a step, one CTA an SM. No
// branch sits between the products of a step (distributed_ba3c_tpu_torch/
// csrc/conv_block_bwd.cu keeps them so). The data is zeros: only the
// timing means anything.
//
// Build and run on the card (nvcc for sm_90a):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//       -o /tmp/wgmma_loop_bench scripts/wgmma_loop_bench.cu && /tmp/wgmma_loop_bench
// Each line: the mode, warpgroups, tiles a step, ms for 3000 steps on 132
// CTAs, the dense bf16 rate reached (of 989 TFLOP/s) and clocks a step an
// SM at the printed clock.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

__device__ __forceinline__ uint32_t su32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n" : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n" : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }
__device__ __forceinline__ uint64_t desc(uint32_t a, uint32_t lbo, uint32_t sbo, uint32_t l) {
  return uint64_t((a & 0x3FFFF) >> 4) | (uint64_t((lbo & 0x3FFFF) >> 4) << 16) | (uint64_t((sbo & 0x3FFFF) >> 4) << 32) | (uint64_t(l) << 62);
}
__device__ __forceinline__ void rs32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, {%16,%17,%18,%19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void ss32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// MODE 0: A in registers, constant; 1: A in registers by ldmatrix.trans a
// step ahead; 4: two steps ahead; 2: A from shared memory through a
// descriptor; 3: mma.sync (a warp's m16n32k16: 4 mma, one A ldmatrix and
// two B ldmatrix.trans)
template <int MODE, int TPW>
__global__ void k(float* out, int steps) {
  extern __shared__ __align__(1024) unsigned char smem[];
  for (int i = threadIdx.x; i < 65536 / 16; i += blockDim.x) reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const uint32_t base = su32(smem);
  float acc[TPW][16];
  for (int t = 0; t < TPW; ++t) for (int e = 0; e < 16; ++e) acc[t][e] = 0.f;
  uint32_t fa[3][TPW][4];
  for (int j = 0; j < 3; ++j) for (int t = 0; t < TPW; ++t) for (int e = 0; e < 4; ++e) fa[j][t][e] = 0;
  auto lda = [&](int s, uint32_t (&f)[TPW][4]) {
#pragma unroll
    for (int t = 0; t < TPW; ++t) ldsm4t(f[t], base + 32768 + ((lane * 80 + s * 256 + t * 1024) & 16383));
  };
  auto bdesc = [&](int s) { return desc(base + ((s & 7) * 1024), 512, 512, 2); };
  if constexpr (MODE == 0) {
    for (int s = 0; s < steps; ++s) { fence(); for (int t = 0; t < TPW; ++t) rs32(acc[t], fa[0][t], bdesc(s)); commit(); wait<1>(); }
  } else if constexpr (MODE == 1) {
    lda(0, fa[0]);
    for (int s = 0; s < steps; s += 2) {
      fence(); for (int t = 0; t < TPW; ++t) rs32(acc[t], fa[0][t], bdesc(s)); commit(); wait<1>(); lda(s + 1, fa[1]);
      fence(); for (int t = 0; t < TPW; ++t) rs32(acc[t], fa[1][t], bdesc(s + 1)); commit(); wait<1>(); lda(s + 2, fa[0]);
    }
  } else if constexpr (MODE == 4) {
    lda(0, fa[0]); lda(1, fa[1]);
    for (int s = 0; s < steps; s += 3) {
      fence(); for (int t = 0; t < TPW; ++t) rs32(acc[t], fa[0][t], bdesc(s)); commit(); wait<1>(); lda(s + 2, fa[2]);
      fence(); for (int t = 0; t < TPW; ++t) rs32(acc[t], fa[1][t], bdesc(s + 1)); commit(); wait<1>(); lda(s + 3, fa[0]);
      fence(); for (int t = 0; t < TPW; ++t) rs32(acc[t], fa[2][t], bdesc(s + 2)); commit(); wait<1>(); lda(s + 4, fa[1]);
    }
  } else if constexpr (MODE == 2) {
    for (int s = 0; s < steps; ++s) {
      fence();
      for (int t = 0; t < TPW; ++t) ss32(acc[t], desc(base + 16384 + t * 8192 + (s & 3) * 32, 16, 1024, 1), bdesc(s));
      commit(); wait<1>();
    }
  } else {  // mma.sync
    for (int s = 0; s < steps; ++s) {
      for (int t = 0; t < TPW; ++t) {
        uint32_t a[4], b[2][4];
        ldsm4t(a, base + 32768 + ((lane * 80 + s * 256 + t * 1024) & 16383));
        ldsm4t(b[0], base + ((lane * 80 + s * 128) & 16383));
        ldsm4t(b[1], base + ((lane * 80 + s * 128 + 32) & 16383));
        float* d = acc[t];
        mma(*reinterpret_cast<float(*)[4]>(d), a, b[0][0], b[0][1]);
        mma(*reinterpret_cast<float(*)[4]>(d + 4), a, b[0][2], b[0][3]);
        mma(*reinterpret_cast<float(*)[4]>(d + 8), a, b[1][0], b[1][1]);
        mma(*reinterpret_cast<float(*)[4]>(d + 12), a, b[1][2], b[1][3]);
      }
    }
  }
  wait<0>();
  float s = 0.f;
  for (int t = 0; t < TPW; ++t) for (int e = 0; e < 16; ++e) s += acc[t][e];
  if (s == 12345.f) out[threadIdx.x] = s;
}

template <int MODE, int TPW>
void run(const char* name, int wgs, int ctas_per_sm) {
  float* out; cudaMalloc(&out, 4096 * 4);
  auto kern = k<MODE, TPW>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 65536);
  const int steps = 3000, grid = 132 * ctas_per_sm;
  kern<<<grid, 128 * wgs, 65536>>>(out, steps);
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int i = 0; i < 5; ++i) kern<<<grid, 128 * wgs, 65536>>>(out, steps);
  cudaEventRecord(b); cudaEventSynchronize(b);
  float ms; cudaEventElapsedTime(&ms, a, b); ms /= 5;
  cudaError_t e = cudaGetLastError();
  // m64n32k16 per warpgroup-tile-step = 65536 flop
  const double flop = 65536.0 * steps * TPW * wgs * grid;
  int khz = 0;
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  printf("%-16s wgs=%d ctas/sm=%d TPW=%d: %.4f ms, %.1f TFLOP/s (%.1f%% of 989), %.1f clk/step/SM at %.3f GHz %s\n",
         name, wgs, ctas_per_sm, TPW, ms, flop / ms / 1e9, flop / ms / 1e9 / 9.89, ms * khz / steps,
         khz / 1e6, e ? cudaGetErrorString(e) : "");
  cudaFree(out);
}

int main() {
  for (int wgs : {1, 2, 3}) {
    run<0, 1>("A regs const", wgs, 1);
    run<0, 4>("A regs const", wgs, 1);
    run<1, 1>("A ldsm 1 ahead", wgs, 1);
    run<1, 4>("A ldsm 1 ahead", wgs, 1);
    run<4, 1>("A ldsm 2 ahead", wgs, 1);
    run<4, 4>("A ldsm 2 ahead", wgs, 1);
    run<2, 1>("A smem desc", wgs, 1);
    run<2, 4>("A smem desc", wgs, 1);
    run<3, 1>("mma.sync", wgs, 1);
    run<3, 4>("mma.sync", wgs, 1);
  }
  return 0;
}
