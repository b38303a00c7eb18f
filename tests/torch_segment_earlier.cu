// The solvers' segment reductions as first written for the port, kept to be
// timed beside the current ones (tests/torch_kernel_ablation_check.py
// --only segment builds it on its own; the package never loads it).  Rows:
// one warp a row, 4-byte loads, one 256-thread block a group of 8 rows.
// 1d: two dependent launches, a first stage of at most 256 blocks writing
// per-block parts to scratch the caller allocates, then one block reducing
// them.  Its min is order-dependent in the sign of a zero.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / kWarp;
constexpr int kWarps = kThreads / kWarp;
constexpr long long kMaxParts = 256;  // first-stage blocks of the 1d reduction

// NaN-propagating minimum (XLA's min): NaN wins, then the smaller value.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}

// True when (a, ia) precedes (b, ib): NaN first, then the smaller value;
// equal values (or two NaNs) go to the smaller index.
__device__ __forceinline__ bool precedes(float a, int32_t ia, float b,
                                         int32_t ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && (!bn || ia < ib);
  return a < b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_min(float& v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = nan_min(__shfl_down_sync(0xffffffffu, v, off), v);
}

__device__ __forceinline__ void warp_argmin(float& v, int32_t& i) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int32_t oi = __shfl_down_sync(0xffffffffu, i, off);
    if (precedes(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Block-wide (value, index) reduction; thread 0 holds the result.
__device__ __forceinline__ void block_argmin(float& v, int32_t& i) {
  __shared__ float sv[kWarps];
  __shared__ int32_t si[kWarps];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  warp_argmin(v, i);
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? sv[lane] : INFINITY;
    i = lane < kWarps ? si[lane] : INT32_MAX;
    warp_argmin(v, i);
  }
}

__global__ void min_rows_kernel(const float* __restrict__ x,
                                float* __restrict__ out, long long rows,
                                long long width) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;  // the whole warp leaves together
  const int lane = threadIdx.x % kWarp;
  const float* r = x + row * width;
  float v = INFINITY;
  for (long long c = lane; c < width; c += kWarp) v = nan_min(r[c], v);
  warp_min(v);
  if (lane == 0) out[row] = v;
}

__global__ void argmin_rows_kernel(const float* __restrict__ x,
                                   int32_t* __restrict__ out, long long rows,
                                   long long width) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;
  const int lane = threadIdx.x % kWarp;
  const float* r = x + row * width;
  float v = INFINITY;
  int32_t i = INT32_MAX;
  for (long long c = lane; c < width; c += kWarp) {
    const float xc = r[c];
    if (precedes(xc, static_cast<int32_t>(c), v, i)) {
      v = xc;
      i = static_cast<int32_t>(c);
    }
  }
  warp_argmin(v, i);
  if (lane == 0) out[row] = i;
}

__global__ void argmin_parts_kernel(const float* __restrict__ x,
                                    float* __restrict__ part_val,
                                    int32_t* __restrict__ part_idx,
                                    long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  float v = INFINITY;
  int32_t i = INT32_MAX;
  for (long long k = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       k < n; k += stride) {
    const float xk = x[k];
    if (precedes(xk, static_cast<int32_t>(k), v, i)) {
      v = xk;
      i = static_cast<int32_t>(k);
    }
  }
  block_argmin(v, i);
  if (threadIdx.x == 0) {
    part_val[blockIdx.x] = v;
    part_idx[blockIdx.x] = i;
  }
}

__global__ void argmin_final_kernel(const float* __restrict__ part_val,
                                    const int32_t* __restrict__ part_idx,
                                    float* __restrict__ out_val,
                                    int32_t* __restrict__ out_idx,
                                    long long parts, long long n) {
  float v = INFINITY;
  int32_t i = INT32_MAX;
  for (long long k = threadIdx.x; k < parts; k += kThreads) {
    if (precedes(part_val[k], part_idx[k], v, i)) {
      v = part_val[k];
      i = part_idx[k];
    }
  }
  block_argmin(v, i);
  if (threadIdx.x == 0) {
    *out_val = v;
    // the JAX form's clamp of the padded flat index, jnp.minimum(i, n - 1)
    *out_idx = i < n - 1 ? i : static_cast<int32_t>(n - 1);
  }
}

}  // namespace

extern "C" {

// out[r] = min of row r of the (rows, width) f32 matrix x.
int segment_min_rows(int device, const void* x, void* out, long long rows,
                     long long width, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows > 0) {
    const unsigned grid =
        static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
    min_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(out), rows, width);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[r] = int32 index of the first minimum of row r.
int segment_argmin_rows(int device, const void* x, void* out, long long rows,
                        long long width, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows > 0) {
    const unsigned grid =
        static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
    argmin_rows_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<int32_t*>(out), rows, width);
  }
  return static_cast<int>(cudaGetLastError());
}

// (*out_val, *out_idx) = (min, first argmin) of the n-element f32 vector x;
// part_val / part_idx are scratch of `parts` entries, 1 <= parts <= 256.
int segment_min_argmin_1d(int device, const void* x, void* part_val,
                          void* part_idx, void* out_val, void* out_idx,
                          long long n, long long parts, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || parts < 1 || parts > kMaxParts)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  argmin_parts_kernel<<<static_cast<unsigned>(parts), kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<float*>(part_val),
      static_cast<int32_t*>(part_idx), n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  argmin_final_kernel<<<1, kThreads, 0, s>>>(
      static_cast<const float*>(part_val),
      static_cast<const int32_t*>(part_idx), static_cast<float*>(out_val),
      static_cast<int32_t*>(out_idx), parts, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
