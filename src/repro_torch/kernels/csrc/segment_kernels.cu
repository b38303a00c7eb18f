// Hand-written CUDA kernels for the storage-graph solvers (Hopper, sm_90a).
//
// The device solver backend (repro_torch/core/solvers/torch_backend.py) lays
// CSR rows out as dense (rows, width) f32 matrices padded with +inf and
// reduces over them.  These kernels replace the Pallas TPU kernel of the JAX
// package that carries every device solver, src/repro/kernels/segment_ops.py
// _row_call (pl.pallas_call), as reached from
//
//   segment_min_rows       <- segment_min_rows     (_min_kernel)
//   segment_argmin_rows    <- segment_argmin_rows  (_argmin_kernel)
//   segment_min_argmin_1d  <- min_argmin_1d        (pad_to_rows + both rows)
//
// and add one kernel that is not a TPU kernel:
//
//   segment_mp_reparent    <- the in-tree re-parenting loop of
//                             src/repro/core/solvers/jax_backend.py _mp_jit
//                             (reparent + _is_ancestor), a sequential
//                             fori_loop inside the jitted MP step there.
//
// Semantics, shared with the plain versions in ../ref.py and with XLA's
// min/argmin: NaN is the minimum and propagates; ties go to the first
// (smallest) index; an all-+inf input gives (+inf, 0); indices are int32.
//
// Bound.  The reductions only read f32 data once, so device memory bounds
// them (3.35 TB/s on an H100 SXM).  At the main path's shapes:
//   rows    131,072 x 32 in-edge matrix: 16 MiB read + 512 KiB written, 5 us;
//   1d      a 131,072-element Prim/MP key: 512 KiB read, 0.16 us, so each
//           call is bound by its two launches' latency, not by bytes.
// mp_reparent does at most width (32) slot tests and a parent-chain walk per
// accepted slot: latency of dependent loads, one launch per MP step.
// Design.  Rows: one warp per row (8 rows per 256-thread block); lanes stride
// the row, so a warp reads 128 contiguous bytes per step, and a shuffle
// reduction combines the lanes.  1d: a fixed grid of at most 256 blocks
// reduces grid-strided slices to one (value, index) each, and a second
// single-block launch reduces those; both launch from one C call, so the
// caller gets device scalars and no host synchronisation.  mp_reparent: one
// thread, because each acceptance rewires the parent chain that the next
// slot's ancestor walk reads.  It reads the selected vertex and the active
// flag from device memory and updates the loop's l / d / p buffers in place.
// Arithmetic is f32 with literals written as f32 (1e-15f), and every add is
// __fadd_rn / __fsub_rn, so no FMA contraction and no promotion to f64
// changes a comparison (the library is built with -fmad=false as well).
// Nothing here allocates or synchronises; each entry point launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / kWarp;
constexpr int kWarps = kThreads / kWarp;
constexpr long long kMaxParts = 256;  // first-stage blocks of the 1d reduction
constexpr float kEps = 1e-15f;        // repro_torch.kernels.ref.EPS

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

__global__ void mp_reparent_kernel(const int32_t* __restrict__ pd,
                                   const float* __restrict__ pdelta,
                                   const float* __restrict__ pphi,
                                   const int32_t* __restrict__ vi_p,
                                   const bool* __restrict__ active_p,
                                   const bool* __restrict__ in_tree,
                                   float* l, float* d, int32_t* p,
                                   long long nvp, long long width) {
  if (!*active_p) return;
  const int32_t vi = *vi_p;
  const long long base = static_cast<long long>(vi) * width;
  for (long long k = 0; k < width; ++k) {
    const int32_t vj = pd[base + k];
    if (vj < 0 || vj > nvp || !in_tree[vj]) continue;  // nvp: padding
    const float cdel = pdelta[base + k];
    const float dn = __fadd_rn(pphi[base + k], d[vi]);
    if (!(dn <= __fadd_rn(d[vj], kEps)) || !(cdel <= __fsub_rn(l[vj], kEps)))
      continue;
    // re-parenting vj under one of its descendants would close a cycle:
    // walk vi's parent chain up to the root looking for vj
    int32_t x = vi;
    while (x > 0 && x != vj) {
      const int32_t px = p[x];
      x = px < 0 ? 0 : px;
    }
    if (x == vj) continue;
    p[vj] = vi;
    d[vj] = dn;
    l[vj] = cdel;
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

// One Modified-Prim re-parenting pass over the row of the selected vertex
// *vi (skipped unless *active); updates l, d, p (nvp + 2 entries) in place.
int segment_mp_reparent(int device, const void* pd, const void* pdelta,
                        const void* pphi, const void* vi, const void* active,
                        const void* in_tree, void* l, void* d, void* p,
                        long long nvp, long long width, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  mp_reparent_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pd), static_cast<const float*>(pdelta),
      static_cast<const float*>(pphi), static_cast<const int32_t*>(vi),
      static_cast<const bool*>(active), static_cast<const bool*>(in_tree),
      static_cast<float*>(l), static_cast<float*>(d), static_cast<int32_t*>(p),
      nvp, width);
  return static_cast<int>(cudaGetLastError());
}

const char* segment_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
