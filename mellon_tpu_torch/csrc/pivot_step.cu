// One step of the greedy diagonally pivoted partial Cholesky for NVIDIA
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs the step as XLA operations
// in a lax.while_loop (mellon_tpu/ops/linalg.py: _pivoted_cholesky), and
// the port ran it as a dozen PyTorch launches a step, which kept the card
// waiting on the host (~0.33 ms of host time against ~25 us of device
// work a step).  That body stays as the plain version
// (ops/hopper_kernels.py: pivot_step_reference).  Here a step is one
// launch that reads its state on the device, so a CUDA graph of launches
// replays any run of steps: PIVOT_CHUNK of them between two host checks of
// the stopping rule (ops/linalg.py), or stage 1's FUSED_PIVOT_CAP inside
// its captured graph (models/fused.py).
//
// The state (ops/hopper_kernels.py: PivotState) lies on the device:
//   ints = {j, r, p, active, ticket, one argmax per block},
//   vals = {thresh, sqrt(d[p]), one max per block}.
// Step j, where active:
//   col = K[:, p] - L[:, :j] L[p, :j],   L[:, j] = col / sqrt(d[p]),
//   d = max(d - L[:, j]^2, 0) with d[p] = 0,   piv[j] = p,   r += 1;
// then the next step's pivot p = argmax d (the lowest index among equal
// maxima, as torch.argmax), sqrt(d[p]) and active &= (max d > thresh).
// A masked step (active false) writes piv[j] = 0 and nothing else: its
// column of L is zero from the state's allocation.  A launch at j >= width
// does nothing, so a graph of a whole chunk may run past the last step.
//
// The bound is reading L[:, :j] once: m j elements a step against 2 m j
// flops.  What the design does about it:
// - One warp per row.  Its lanes read the row in 16-byte vectors,
//   neighbouring lanes on neighbouring vectors (L's rows have a stride
//   that is a multiple of 4 elements), and accumulate in the element type
//   with IEEE fma (no TF32, no lower precision than the input's).
// - The pivot's row L[p, :j] is staged in shared memory once per block, in
//   tiles of TILE elements, and read from there by the block's 8 rows.
// - K's column p is read, one element per row, as the plain version reads
//   it: the step is then the same for a K that is not bitwise symmetric
//   (the double tile of csrc/matern52_tile.cu does not mirror its blocks).
//   It costs one 32-byte sector a row, ~1% of the row's bytes at j = 64.
// - The residual update is rounded as the plain version's d - l * l, with
//   no contraction into an fma (__fmul_rn, __fsub_rn), so that the two pick
//   the same pivots wherever their columns agree.
// - No block reads a value that another block of the same launch writes:
//   every block reads the state (j, p, active, sqrt(d[p])) that the
//   previous launch left, updates its own rows of L and d, and leaves its
//   rows' (max, argmax) of the new d; the last block to finish (an atomic
//   ticket) reduces those and writes the next state.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libpivot_step.so pivot_step.cu

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int WARPS = 8;  // rows of a block: one a warp
constexpr int NTHREADS = WARPS * 32;
constexpr int TILE = 2048;  // elements of the pivot's row staged at a time

// the state's slots (hopper_kernels.PivotState)
enum { J = 0, R = 1, P = 2, ACTIVE = 3, TICKET = 4, INT_PARTS = 5 };
enum { THRESH = 0, SQRT_DP = 1, VAL_PARTS = 2 };

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  using type = float4;
  static constexpr int N = 4;
  __device__ static float fma_dot(float4 a, float4 b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
  }
  __device__ static float lowest() { return -__int_as_float(0x7f800000); }
  __device__ static float mul_rn(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float sub_rn(float a, float b) { return __fsub_rn(a, b); }
};

template <>
struct Vec<double> {
  using type = double2;
  static constexpr int N = 2;
  __device__ static double fma_dot(double2 a, double2 b, double acc) {
    acc = fma(a.x, b.x, acc);
    return fma(a.y, b.y, acc);
  }
  __device__ static double lowest() { return -__longlong_as_double(0x7ff0000000000000LL); }
  __device__ static double mul_rn(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double sub_rn(double a, double b) { return __dsub_rn(a, b); }
};

// (v, i) before (best, bi): the larger value, the lower index among equals
template <typename T>
__device__ inline bool before(T v, long long i, T best, long long bi) {
  return v > best || (v == best && i < bi);
}

// the (max, argmax) over a warp's lanes, in every lane
template <typename T>
__device__ inline void warp_argmax(T& v, long long& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const T ov = __shfl_xor_sync(0xffffffffu, v, o);
    const long long oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// the (max, argmax) over a block's lanes, in thread 0
template <typename T>
__device__ inline void block_argmax(T& v, long long& i, T* smax, long long* sarg) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  warp_argmax(v, i);
  if (lane == 0) {
    smax[warp] = v;
    sarg[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? smax[lane] : Vec<T>::lowest();
    i = lane < WARPS ? sarg[lane] : LLONG_MAX;
    warp_argmax(v, i);
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
pivot_step_kernel(const T* __restrict__ K, T* __restrict__ L, T* __restrict__ d,
                  long long* __restrict__ piv, long long* ints, T* vals, int m, int width,
                  int ldl) {
  using V = typename Vec<T>::type;
  constexpr int N = Vec<T>::N;
  __shared__ __align__(16) T row_p[TILE];
  __shared__ T smax[WARPS];
  __shared__ long long sarg[WARPS];
  __shared__ bool last;

  const long long j = ints[J];
  if (j >= width) return;
  const bool active = ints[ACTIVE] != 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + warp;

  if (active) {
    const int p = static_cast<int>(ints[P]);
    const int jj = static_cast<int>(j);
    const T* lp = L + static_cast<size_t>(p) * ldl;
    const T* li = L + static_cast<size_t>(row < m ? row : p) * ldl;
    T acc = 0;
    for (int t0 = 0; t0 < jj; t0 += TILE) {
      const int len = min(TILE, jj - t0);
      const int nvec = len / N;
      __syncthreads();  // the block is done with the previous tile
      for (int v = threadIdx.x; v < nvec; v += NTHREADS)
        reinterpret_cast<V*>(row_p)[v] = reinterpret_cast<const V*>(lp + t0)[v];
      for (int e = nvec * N + threadIdx.x; e < len; e += NTHREADS) row_p[e] = lp[t0 + e];
      __syncthreads();
      if (row < m) {
        const V* a = reinterpret_cast<const V*>(li + t0);
        const V* b = reinterpret_cast<const V*>(row_p);
#pragma unroll 4
        for (int v = lane; v < nvec; v += 32) acc = Vec<T>::fma_dot(a[v], b[v], acc);
        for (int e = nvec * N + lane; e < len; e += 32) acc = fma(li[t0 + e], row_p[e], acc);
      }
    }
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);

    T dn = Vec<T>::lowest();
    long long arg = LLONG_MAX;
    if (lane == 0 && row < m) {
      const T col = K[static_cast<size_t>(row) * m + p] - acc;
      const T l = col / vals[SQRT_DP];
      L[static_cast<size_t>(row) * ldl + jj] = l;
      const T rest = Vec<T>::sub_rn(d[row], Vec<T>::mul_rn(l, l));
      dn = row == p ? T(0) : (rest > T(0) ? rest : T(0));
      d[row] = dn;
      arg = row;
    }
    block_argmax(dn, arg, smax, sarg);
    if (threadIdx.x == 0) {
      vals[VAL_PARTS + blockIdx.x] = dn;
      ints[INT_PARTS + blockIdx.x] = arg;
    }
  }

  if (threadIdx.x == 0) {
    __threadfence();  // this block's partial is visible before its ticket
    const unsigned long long ticket =
        atomicAdd(reinterpret_cast<unsigned long long*>(ints + TICKET), 1ULL);
    last = ticket == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  if (active) {
    T best = Vec<T>::lowest();
    long long bi = LLONG_MAX;
    for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += NTHREADS) {
      const T v = __ldcg(vals + VAL_PARTS + b);
      const long long i = __ldcg(ints + INT_PARTS + b);
      if (before(v, i, best, bi)) {
        best = v;
        bi = i;
      }
    }
    __syncthreads();  // smax/sarg are free again
    block_argmax(best, bi, smax, sarg);
    if (threadIdx.x == 0) {
      piv[j] = ints[P];
      ints[R] += 1;
      ints[P] = bi;
      vals[SQRT_DP] = sqrt(best);
      ints[ACTIVE] = best > vals[THRESH] ? 1 : 0;
    }
  } else if (threadIdx.x == 0) {
    piv[j] = 0;
  }
  if (threadIdx.x == 0) {
    ints[TICKET] = 0;
    ints[J] = j + 1;
  }
}

template <typename T>
int launch(const T* K, T* L, T* d, long long* piv, long long* ints, T* vals, int m, int width,
           int ldl, int device, void* stream) {
  // this library links its own CUDA runtime, whose current device is not
  // the caller's: select the device that owns the state and the stream
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (m + WARPS - 1) / WARPS;
  pivot_step_kernel<T><<<blocks, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      K, L, d, piv, ints, vals, m, width, ldl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The rows of a block: the state's partials number ceil(m / this).
int pivot_step_block_rows() { return WARPS; }

// K (m, m) contiguous; L (m, width) with rows `ldl` elements apart, ldl a
// multiple of 4, 16-byte aligned; d (m,); piv (width,); ints (5 + blocks)
// and vals (2 + blocks), blocks = ceil(m / pivot_step_block_rows()): the
// state on CUDA device `device` (hopper_kernels.PivotState).  Launches one
// step on `stream`, allocates nothing and does not synchronise.  Returns
// cudaGetLastError() after the launch (0 on success).
int pivot_step_f32(const float* K, float* L, float* d, long long* piv, long long* ints,
                   float* vals, int m, int width, int ldl, int device, void* stream) {
  return launch<float>(K, L, d, piv, ints, vals, m, width, ldl, device, stream);
}

int pivot_step_f64(const double* K, double* L, double* d, long long* piv, long long* ints,
                   double* vals, int m, int width, int ldl, int device, void* stream) {
  return launch<double>(K, L, d, piv, ints, vals, m, width, ldl, device, stream);
}

// Loads both kernels on `device` (the runtime loads a kernel at its first
// launch otherwise, which a CUDA graph's capture should not have to do).
int pivot_step_load(int device) {
  cudaError_t err = cudaSetDevice(device);
  cudaFuncAttributes attributes;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attributes, pivot_step_kernel<float>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attributes, pivot_step_kernel<double>);
  return static_cast<int>(err);
}

const char* pivot_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
