// Hand-written CUDA kernels over the 4 KiB block layout (Hopper, sm_90a):
// the paper's XOR delta and the per-block content hash.
//
//   block_xor_delta  replaces src/repro/kernels/xor_delta.py
//                    xor_delta (_xor_kernel)
//   block_hash       replaces src/repro/kernels/block_diff.py
//                    block_hash (_hash_kernel)
//
// Bound.  Both only stream integer data, so device memory bounds them
// (3.35 TB/s on an H100 SXM).  On one 128 MiB leaf (nb = 32768 blocks):
//   xor   reads a and b and writes a new output: 3 * 128 MiB, 120 us;
//   hash  reads x once (128 MiB), the 4 KiB multiplier table and writes
//         nb int32: 40 us.  Its 33.5 M multiply-adds are ~2 us of the
//         card's int32 rate.
// Design.
//   xor   every thread moves a fixed chunk of four 16-byte (int4) words
//         of a and b, 256 threads apart (so a warp's accesses stay
//         coalesced), all four pairs loaded before any is stored, so four
//         independent pairs are in flight; one CTA per 1024 words, as many
//         CTAs as the data needs (no grid-stride loop).  Measured on an H100
//         at 32,768 blocks beside torch.bitwise_xor in one process
//         (tests/torch_kernel_ablation_check.py): this 0.1331 ms, torch
//         0.1332 ms; with streaming hints (ld/st.global.cs) 0.1366 ms; a
//         grid-stride loop over a grid sized to the card (SMs x resident
//         CTAs) with the hints 0.1422 ms.
//         The TPU kernel aliased its output to a
//         (input_output_aliases={0: 0}); the port never writes into a
//         wrapper's argument, so the output is a third buffer (counted in
//         the bound above).
//   hash  one thread block of 256 threads per 4 KiB block, the shape of
//         delta_changed_block_mask: each thread loads one int4 of x and the
//         matching int4 of multipliers, multiplies and adds in uint32 (signed
//         overflow is undefined in C++; the wrapped sum mod 2^32 is the
//         defined result, and its bits are the int32 hash), then a
//         warp-shuffle sum and a shared-memory sum over the 8 warps.  Each
//         thread only ever needs its own four multipliers, so they are read
//         straight into registers through the read-only data cache, where
//         the 4 KiB table stays resident: staging it in shared memory would
//         add a barrier and buy nothing, and __constant__ memory would
//         serialise a warp's 32 distinct addresses.  Addition mod 2^32 is
//         associative and commutative, so any summation order is bit-exact.
// Nothing here allocates or synchronises; each entry point launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // int4 words per 4 KiB block
constexpr int kWarps = kThreads / 32;
constexpr int kXorWords = 4;  // int4 pairs in flight per thread

__global__ void __launch_bounds__(kThreads)
xor_delta_kernel(const int4* __restrict__ a, const int4* __restrict__ b,
                 int4* __restrict__ out, long long n) {
  const long long base =
      static_cast<long long>(blockIdx.x) * kThreads * kXorWords + threadIdx.x;
  int4 x[kXorWords], y[kXorWords];
#pragma unroll
  for (int u = 0; u < kXorWords; ++u) {
    const long long i = base + u * kThreads;
    if (i < n) {
      x[u] = a[i];
      y[u] = b[i];
    }
  }
#pragma unroll
  for (int u = 0; u < kXorWords; ++u) {
    const long long i = base + u * kThreads;
    if (i < n) {
      out[i] = make_int4(x[u].x ^ y[u].x, x[u].y ^ y[u].y, x[u].z ^ y[u].z,
                         x[u].w ^ y[u].w);
    }
  }
}

__global__ void block_hash_kernel(const uint4* __restrict__ x,
                                  const uint4* __restrict__ coef,
                                  uint32_t* __restrict__ out) {
  __shared__ uint32_t warp_sum[kWarps];
  const uint4 v = x[static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x];
  const uint4 c = __ldg(&coef[threadIdx.x]);
  uint32_t s = v.x * c.x + v.y * c.y + v.z * c.z + v.w * c.w;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kWarps ? warp_sum[lane] : 0u;
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, off);
    }
    if (lane == 0) out[blockIdx.x] = s;
  }
}

}  // namespace

extern "C" {

// out = a ^ b over n16 int4 words (a, b, out: 16-byte aligned).
int block_xor_delta(int device, const void* a, const void* b, void* out,
                    long long n16, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n16 > 0) {
    const long long grid = (n16 + kThreads * kXorWords - 1) / (kThreads * kXorWords);
    xor_delta_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int4*>(a), static_cast<const int4*>(b),
        static_cast<int4*>(out), n16);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[i] = sum over block i of x * coef, mod 2^32; x: nb blocks, coef: one
// block of multipliers, out: nb 32-bit words.
int block_hash(int device, const void* x, const void* coef, void* out,
               long long nb, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb > 0) {
    block_hash_kernel<<<static_cast<unsigned>(nb), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(x), static_cast<const uint4*>(coef),
        static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
