// Every float from 1e-12 to FLT_MAX: the Matern-5/2 tile's branch-free
// sqrt_t (mellon_tpu_torch/csrc/matern52_tile.cu, included here) against
// sqrtf, bit for bit.  Exits 0 when all agree.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/check_sqrt_rn scripts/check_sqrt_rn.cu && build/check_sqrt_rn

#include <cstdio>
#include <cstring>

#include "../mellon_tpu_torch/csrc/matern52_tile.cu"

__global__ void compare(unsigned lo, unsigned hi, unsigned long long* bad, unsigned* first) {
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long b = lo + blockIdx.x * static_cast<unsigned long long>(blockDim.x) + threadIdx.x;
       b <= hi; b += stride) {
    const float a = __uint_as_float(static_cast<unsigned>(b));
    if (__float_as_uint(sqrt_t(a)) != __float_as_uint(sqrtf(a))) {
      atomicAdd(bad, 1ull);
      atomicMin(first, static_cast<unsigned>(b));
    }
  }
}

int main() {
  const float lo_f = 1e-12f, hi_f = 3.40282346638528859812e38f;
  unsigned lo, hi;
  std::memcpy(&lo, &lo_f, 4);
  std::memcpy(&hi, &hi_f, 4);
  unsigned long long* bad;
  unsigned* first;
  cudaMallocManaged(&bad, sizeof(*bad));
  cudaMallocManaged(&first, sizeof(*first));
  *bad = 0;
  *first = 0xffffffffu;
  compare<<<132 * 8, 256>>>(lo, hi, bad, first);
  const cudaError_t err = cudaDeviceSynchronize();
  std::printf("sqrt_t vs sqrtf: %u floats from 1e-12 up, %llu differ (first 0x%08x); %s\n",
              hi - lo + 1, *bad, *first, cudaGetErrorString(err));
  return err != cudaSuccess || *bad != 0;
}
