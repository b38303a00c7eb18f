// Hand-written CUDA kernels for the block-sparse delta path (Hopper, sm_90a).
//
// The store views every tensor's bytes as rows of 4 KiB ("blocks": 1024
// int32 words, logically (8, 128)).  These kernels replace the three Pallas
// TPU kernels of the JAX package that carry commit and checkout:
//
//   delta_changed_block_mask  replaces src/repro/kernels/block_diff.py
//                             changed_block_mask (_mask_kernel)
//   delta_sparse_scatter      replaces src/repro/kernels/sparse_apply.py
//                             sparse_delta_apply (_apply_kernel)
//   delta_chain_winner +      replace src/repro/kernels/chain_apply.py
//   delta_chain_copy          _chain_call (_fold_dest + _chain_kernel)
//
// Bound.  All three only move integer data, so device memory bounds them
// (3.35 TB/s on an H100 SXM).  At the main path's largest leaf (nb = 32768
// blocks, 128 MiB):
//   mask     reads 2 * nb * 4096 bytes and writes nb * 4: 268 MB, 80 us;
//   scatter  returns a new tensor: base read once and the output written once
//            (2 * 128 MiB, 80 us) plus k * 4100 bytes of delta;
//   chain    the same, with only the winning slots of the chain read.
// Design.  One thread block of 256 threads per 4 KiB block; each thread moves
// one 16-byte int4, so a warp reads 512 contiguous bytes per access.  The
// mask combines the threads' verdicts with __syncthreads_or and one thread
// writes the flag.  The scatter and the chain copy leave the bulk copy of the
// base to the wrapper (base.clone(), a device memcpy) and touch only the
// changed rows.  The chain resolves last-writer-wins with an atomicMax of the
// slot id per row (order-independent, hence deterministic), then copies only
// the winning slots, so no trash row is needed.  Nothing here allocates or
// synchronises; each entry point launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // int4 words per 4 KiB block

__global__ void changed_block_mask_kernel(const int4* __restrict__ a,
                                          const int4* __restrict__ b,
                                          int32_t* __restrict__ out) {
  const size_t off = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int4 x = a[off];
  const int4 y = b[off];
  const int diff = (x.x != y.x) | (x.y != y.y) | (x.z != y.z) | (x.w != y.w);
  const int any = __syncthreads_or(diff);
  if (threadIdx.x == 0) out[blockIdx.x] = any ? 1 : 0;
}

__global__ void sparse_scatter_kernel(const int4* __restrict__ blocks,
                                      const int32_t* __restrict__ idx,
                                      int4* __restrict__ out, long long nb) {
  const int32_t row = idx[blockIdx.x];
  if (row < 0 || row >= nb) return;  // padding
  out[static_cast<size_t>(row) * kThreads + threadIdx.x] =
      blocks[static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x];
}

__global__ void chain_winner_kernel(const int32_t* __restrict__ idx,
                                    int32_t* __restrict__ winner, long long s,
                                    long long nrows) {
  const long long slot =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (slot >= s) return;
  const int32_t row = idx[slot];
  if (row < 0 || row >= nrows) return;  // padding
  atomicMax(&winner[row], static_cast<int32_t>(slot));
}

__global__ void chain_copy_kernel(const int4* __restrict__ blocks,
                                  const int32_t* __restrict__ idx,
                                  const int32_t* __restrict__ winner,
                                  int4* __restrict__ out, long long nrows) {
  const int32_t slot = static_cast<int32_t>(blockIdx.x);
  const int32_t row = idx[slot];
  if (row < 0 || row >= nrows || winner[row] != slot) return;
  out[static_cast<size_t>(row) * kThreads + threadIdx.x] =
      blocks[static_cast<size_t>(slot) * kThreads + threadIdx.x];
}

}  // namespace

extern "C" {

// out[i] = 1 where block i of a and b differ; a, b: nb blocks; out: nb int32.
int delta_changed_block_mask(int device, const void* a, const void* b,
                             void* out, long long nb, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb > 0) {
    changed_block_mask_kernel<<<static_cast<unsigned>(nb), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int4*>(a), static_cast<const int4*>(b),
        static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// out[idx[k]] = blocks[k] for 0 <= idx[k] < nb; out already holds the base.
int delta_sparse_scatter(int device, const void* blocks, const void* idx,
                         void* out, long long k, long long nb, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k > 0) {
    sparse_scatter_kernel<<<static_cast<unsigned>(k), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int4*>(blocks), static_cast<const int32_t*>(idx),
        static_cast<int4*>(out), nb);
  }
  return static_cast<int>(cudaGetLastError());
}

// winner[row] = max slot writing row; winner arrives filled with -1.
int delta_chain_winner(int device, const void* idx, void* winner, long long s,
                       long long nrows, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s > 0) {
    const unsigned grid = static_cast<unsigned>((s + kThreads - 1) / kThreads);
    chain_winner_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(idx), static_cast<int32_t*>(winner), s,
        nrows);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[idx[s]] = blocks[s] for each slot s that won its row.
int delta_chain_copy(int device, const void* blocks, const void* idx,
                     const void* winner, void* out, long long s,
                     long long nrows, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s > 0) {
    chain_copy_kernel<<<static_cast<unsigned>(s), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int4*>(blocks), static_cast<const int32_t*>(idx),
        static_cast<const int32_t*>(winner), static_cast<int4*>(out), nrows);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* delta_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
