// Throughput of 16-byte shared-memory loads (LDS.128) for the warp access
// patterns of the Matern-5/2 tile's cross term, 16 warps on every SM.
// Prints SM-cycles per warp-wide load at the card's 1980 MHz boost clock.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/lds128_bench scripts/lds128_bench.cu
//   build/lds128_bench
#include <cstdio>
#include <cuda_runtime.h>
template <int PATTERN>
__global__ void __launch_bounds__(256) bench(float* out, int iters) {
  __shared__ __align__(16) float s[4096];
  for (int i = threadIdx.x; i < 4096; i += 256) s[i] = i * 1e-3f;
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int off;
  if (PATTERN == 0) off = 0;                              // all lanes one address
  else if (PATTERN == 1) off = (lane / 16) * 4;           // 2 addresses (x rows)
  else if (PATTERN == 2) off = (lane % 16) * 4;           // 16 addresses, each twice (y columns)
  else if (PATTERN == 3) off = lane * 4;                  // 32 distinct, contiguous
  else off = (lane / 8) * 4;                              // one address per quarter-warp
  off += warp * 132;
  float4 acc = make_float4(0, 0, 0, 0);
  for (int it = 0; it < iters; ++it) {
    const int base = (it & 15) * 260;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float4 v = *reinterpret_cast<const float4*>(s + ((base + off + u * 32) & 4095 & ~3));
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
  }
  if (acc.x == -1.f) out[threadIdx.x] = acc.y + acc.z + acc.w;
}
int main() {
  float* out; cudaMalloc(&out, 4096);
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  const int iters = 4096, blocks = 132 * 2;
  const char* names[] = {"same address", "2 addresses (x rows)", "16 addr x2 (y cols)", "32 distinct", "1 per quarter"};
  for (int rep = 0; rep < 2; ++rep)
  for (int p = 0; p < 5; ++p) {
    float ms;
    for (int w = 0; w < 2; ++w) {
      cudaEventRecord(a);
      switch (p) {
        case 0: bench<0><<<blocks, 256>>>(out, iters); break;
        case 1: bench<1><<<blocks, 256>>>(out, iters); break;
        case 2: bench<2><<<blocks, 256>>>(out, iters); break;
        case 3: bench<3><<<blocks, 256>>>(out, iters); break;
        default: bench<4><<<blocks, 256>>>(out, iters); break;
      }
      cudaEventRecord(b); cudaEventSynchronize(b);
      cudaEventElapsedTime(&ms, a, b);
    }
    const double warp_lds = (double)blocks * 8 * iters * 8;
    const double cycles = ms * 1e-3 * 1.98e9 * 132;
    printf("%-18s: %.3f ms, %.2f SM-cycles per warp LDS.128\n", names[p], ms, cycles / warp_lds);
  }
  return 0;
}
