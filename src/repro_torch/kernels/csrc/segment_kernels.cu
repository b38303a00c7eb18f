// Hand-written CUDA kernels for the storage-graph solvers (Hopper, sm_90a).
//
// The device solver backend (repro_torch/core/solvers/torch_backend.py) lays
// CSR rows out as dense (rows, width) f32 matrices padded with +inf and
// reduces over them.  Three kernels replace the Pallas TPU kernel of the JAX
// package that carries every device solver, src/repro/kernels/segment_ops.py
// _row_call (pl.pallas_call), as reached from
//
//   segment_min_rows       <- segment_min_rows     (_min_kernel)
//   segment_argmin_rows    <- segment_argmin_rows  (_argmin_kernel)
//   segment_min_argmin_1d  <- min_argmin_1d        (pad_to_rows + both rows)
//
// and two run a whole solver's step loop in one launch:
//
//   segment_prim_loop      <- the fori_loop of src/repro/core/solvers/
//                             jax_backend.py _prim_jit: each step a
//                             min_argmin_1d over the masked key, then one
//                             scatter over the selected out-row;
//   segment_mp_loop        <- the fori_loop of _mp_jit: the same selection,
//                             the in-tree re-parenting (reparent +
//                             _is_ancestor, a sequential fori_loop there)
//                             and the frontier relaxation under theta.
//
// Semantics, shared with the plain versions in ../ref.py and with XLA's
// min/argmin: NaN is the minimum and propagates; ties go to the first
// (smallest) index; an all-+inf input gives (+inf, 0); indices are int32.
//
// Bound.  The reductions only read f32 data once, so device memory bounds
// them (3.35 TB/s on an H100 SXM).  At the main path's shapes:
//   rows    131,072 x 32 in-edge matrix: 16 MiB read + 512 KiB written, 5 us;
//   1d      a 2**20-element LMG candidate vector: 4 MiB read, 1.3 us.
// The loops move few bytes (each selected row read once, the state written
// once: tens of us at 66,000 steps) and are bound by latency: a step cannot
// start before the previous one has chosen its vertex, so the floor is
// steps x (a block barrier + a dependent L2 load), which
// segment_loop_floor measures.
//
// Design.  Rows: one warp per row (8 rows per 256-thread block); lanes stride
// the row, so a warp reads 128 contiguous bytes per step, and a shuffle
// reduction combines the lanes.  1d: a fixed grid of at most 256 blocks
// reduces grid-strided slices to one (value, index) each, and a second
// single-block launch reduces those; both launch from one C call, so the
// caller gets device scalars and no host synchronisation.
// Loops: one persistent block of 1,024 threads runs all the steps, so no
// step waits for the host and no grid barrier is needed (a loop step picks
// one vertex: there is nothing for a second block to do).  The selection
// keeps the (value, first index) minimum of each chunk of `chunk` keys in
// shared memory, built once; a step reduces those chunk minima, and after
// its writes recomputes only the chunks that hold a key it changed (the
// selected vertex's, now +inf, and each relaxed destination's), one warp per
// chunk, instead of re-reducing all keys as the JAX form does.  Each step
// costs three block barriers and three dependent global round trips: the
// selected row, the gathers at its destinations, the dirty chunks.
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
constexpr int kLoopThreads = 1024;    // the loops' one block
constexpr int kLoopWarps = kLoopThreads / kWarp;
constexpr int kMaxChunks = 2048;      // chunk minima held in shared memory

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

// ------------------------------------------------------------ step loops
// Every lane gets the (value, index) minimum of the warp's pairs.  The order
// `precedes` is total, so the butterfly gives all lanes one answer.
__device__ __forceinline__ void warp_argmin_all(float& v, int32_t& i) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int32_t oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (precedes(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

struct LoopShared {
  float cv[kMaxChunks];                 // each chunk's minimum key ...
  int32_t ci[kMaxChunks];               // ... and its first index
  uint32_t dirty_bit[kMaxChunks / 32];  // chunks already listed this step
  int32_t dirty[kMaxChunks];            // chunks to recompute this step
  int ndirty;
  float wv[kLoopWarps];                 // the selection's per-warp minima
  int32_t wi[kLoopWarps];
};

// The key of vertex k: +inf once it is in the tree, else its best (Prim) or
// l (MP).  `key` and `in_tree` are written by the loop, so they are read
// with plain loads (never through the non-coherent read-only path).
__device__ __forceinline__ void chunk_min(const bool* in_tree, const float* key,
                                          int c, int chunk, long long nvp,
                                          float& v, int32_t& i) {
  const long long lo = static_cast<long long>(c) * chunk;
  const long long hi = lo + chunk < nvp ? lo + chunk : nvp;
  v = INFINITY;
  i = INT32_MAX;
#pragma unroll 4
  for (long long k = lo + threadIdx.x % kWarp; k < hi; k += kWarp) {
    const bool t = in_tree[k];
    const float kv = key[k];  // both loads in flight at once
    const float x = t ? INFINITY : kv;
    if (precedes(x, static_cast<int32_t>(k), v, i)) {
      v = x;
      i = static_cast<int32_t>(k);
    }
  }
  warp_argmin_all(v, i);
}

// Warp w builds the minima of chunks w, w + 32, ...; the caller syncs.
__device__ void init_chunks(LoopShared& s, const bool* in_tree,
                            const float* key, int nchunks, int chunk,
                            long long nvp) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int c = warp; c < nchunks; c += kLoopWarps) {
    float v;
    int32_t i;
    chunk_min(in_tree, key, c, chunk, nvp, v, i);
    if (lane == 0) {
      s.cv[c] = v;
      s.ci[c] = i;
    }
  }
  for (int w = threadIdx.x; w < kMaxChunks / 32; w += kLoopThreads)
    s.dirty_bit[w] = 0;
  if (threadIdx.x == 0) s.ndirty = 0;
}

// The step's vertex: (min, first argmin) of the chunk minima, in every
// thread.  One block barrier.
__device__ __forceinline__ void select_min(LoopShared& s, int nchunks,
                                           float& v, int32_t& i) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  v = INFINITY;
  i = INT32_MAX;
  for (int c = threadIdx.x; c < nchunks; c += kLoopThreads) {
    if (precedes(s.cv[c], s.ci[c], v, i)) {
      v = s.cv[c];
      i = s.ci[c];
    }
  }
  warp_argmin_all(v, i);
  if (lane == 0) {
    s.wv[warp] = v;
    s.wi[warp] = i;
  }
  __syncthreads();
  v = s.wv[lane];
  i = s.wi[lane];
  warp_argmin_all(v, i);
}

// List chunk c for recomputation once per step.
__device__ __forceinline__ void mark_dirty(LoopShared& s, int c) {
  const uint32_t bit = 1u << (c % 32);
  if (!(atomicOr(&s.dirty_bit[c / 32], bit) & bit))
    s.dirty[atomicAdd(&s.ndirty, 1)] = c;
}

// Recompute the listed chunks, one warp each; the caller syncs before (the
// list and the step's writes complete) and after.
__device__ void recompute_dirty(LoopShared& s, const bool* in_tree,
                                const float* key, int chunk, long long nvp) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nd = s.ndirty;
  for (int j = warp; j < nd; j += kLoopWarps) {
    const int c = s.dirty[j];
    float v;
    int32_t i;
    chunk_min(in_tree, key, c, chunk, nvp, v, i);
    if (lane == 0) {
      s.cv[c] = v;
      s.ci[c] = i;
      s.dirty_bit[c / 32] = 0;
    }
  }
}

// Prim (the JAX package's _prim_jit body), `steps` times:
//   key = in_tree ? +inf : best;  (bmin, u) = min_argmin(key);
//   in_tree[u] = true;
//   if bmin is finite: for each slot k of u's row with vs = pd[u, k] not in
//     the tree and pw[u, k] < best[vs]: best[vs] = pw[u, k], bp[vs] = u.
// A row lists distinct ids (EdgeArrays dedups (src, dst)), so no two lanes
// write one destination; the padding id nvp is skipped (its weight is +inf:
// it never relaxes anything in the plain version either), and so is vs == u,
// which the plain version sees as in the tree.
// Early exit: once bmin is +inf every key is +inf, so every later step picks
// u = 0 (the root, already in the tree) and changes nothing: best, bp and
// in_tree are final.  A NaN or -inf minimum does not end the loop: that step
// still puts u in the tree (and relaxes nothing), and later steps go on.
__global__ void __launch_bounds__(kLoopThreads, 1)
prim_loop_kernel(const int32_t* __restrict__ pd, const float* __restrict__ pw,
                 float* best, int32_t* bp, bool* in_tree, long long nvp,
                 long long width, long long steps, int chunk) {
  __shared__ LoopShared s;
  const int nchunks = static_cast<int>((nvp + chunk - 1) / chunk);
  init_chunks(s, in_tree, best, nchunks, chunk, nvp);
  __syncthreads();
  for (long long step = 0; step < steps; ++step) {
    float bmin;
    int32_t u;
    select_min(s, nchunks, bmin, u);
    if (bmin == INFINITY) break;  // uniform: every thread holds one bmin
    if (threadIdx.x == 0) {
      in_tree[u] = true;
      mark_dirty(s, u / chunk);
    }
    if (isfinite(bmin)) {
      const long long base = static_cast<long long>(u) * width;
      for (long long k = threadIdx.x; k < width; k += kLoopThreads) {
        const int32_t vs = pd[base + k];
        if (vs < 0 || vs >= nvp || vs == u) continue;
        const float ws = pw[base + k];
        if (!in_tree[vs] && ws < best[vs]) {
          best[vs] = ws;
          bp[vs] = u;
          mark_dirty(s, vs / chunk);
        }
      }
    }
    __syncthreads();
    recompute_dirty(s, in_tree, best, chunk, nvp);
    __syncthreads();
    if (threadIdx.x == 0) s.ndirty = 0;  // next listed after next selection
  }
}

// Modified Prim (the JAX package's _mp_jit step), `steps` times:
//   key = in_tree ? +inf : l;  (li, vi) = min_argmin(key);
//   if li is not finite the step changes nothing (see below); else
//   in_tree[vi] = true, and for each slot k of vi's row, vj = pd[vi, k],
//   dn = pphi[vi, k] + d[vi]:
//   * vj in the tree (re-parenting, Algorithm 2 lines 10-17): accepted when
//     dn <= d[vj] + EPS, pdelta[vi, k] <= l[vj] - EPS and vj is not on vi's
//     parent chain (vi, p[vi], ..., the root 0); then p[vj] = vi,
//     d[vj] = dn, l[vj] = pdelta[vi, k];
//   * vj not in the tree (the frontier): when dn <= bound and
//     pdelta[vi, k] < l[vj] - EPS, the same three writes.
// The plain version walks the re-parenting slots in order, each walk over
// the chain as the slots before it left it.  Here the slots run in parallel
// and the chain is walked once, which gives the same result:
//   - slot k's tests read only d[vi], d[vj_k], l[vj_k] and the chain;
//   - an acceptance writes only p, d and l of vj_k;
//   - an accepted vj_k is not on the chain, so writing p[vj_k] leaves the
//     chain as it was, and vj_k != vi leaves d[vi] as it was;
//   - the ids of a row are distinct, so no slot's vj is another's.
// The frontier writes only vertices outside the tree, and the chain holds
// tree vertices only (a parent is set to a vertex already in the tree), so
// it does not touch what the re-parenting reads either.  The chain is
// walked (one thread, a dependent load a link) only in a step where some
// slot passes both cost tests, marking its vertices with the step's stamp
// in `mark`; a candidate is on the chain when its mark equals the stamp.
// Early exit: a step whose minimum is not finite changes nothing (in_tree,
// l, d, p all stay), so the next step selects the same vertex again: l, d,
// p and in_tree are final.
__global__ void __launch_bounds__(kLoopThreads, 1)
mp_loop_kernel(const int32_t* __restrict__ pd,
               const float* __restrict__ pdelta,
               const float* __restrict__ pphi,
               const float* __restrict__ bound_p, float* l, float* d,
               int32_t* p, bool* in_tree, int32_t* mark, long long nvp,
               long long width, long long steps, int chunk) {
  __shared__ LoopShared s;
  const float bound = *bound_p;
  const int nchunks = static_cast<int>((nvp + chunk - 1) / chunk);
  init_chunks(s, in_tree, l, nchunks, chunk, nvp);
  __syncthreads();
  for (long long step = 0; step < steps; ++step) {
    float li;
    int32_t vi;
    select_min(s, nchunks, li, vi);
    if (!isfinite(li)) break;  // uniform: every thread holds one li
    if (threadIdx.x == 0) {
      in_tree[vi] = true;
      mark_dirty(s, vi / chunk);
    }
    const long long base = static_cast<long long>(vi) * width;
    const float dvi = d[vi];
    bool cand = false;
    for (long long k = threadIdx.x; k < width; k += kLoopThreads) {
      const int32_t vj = pd[base + k];
      if (vj < 0 || vj >= nvp) continue;  // nvp: padding
      const float dn = __fadd_rn(pphi[base + k], dvi);
      const float cdel = pdelta[base + k];
      if (vj == vi || in_tree[vj]) {
        cand |= dn <= __fadd_rn(d[vj], kEps) && cdel <= __fsub_rn(l[vj], kEps);
      } else if (dn <= bound && cdel < __fsub_rn(l[vj], kEps)) {
        d[vj] = dn;
        l[vj] = cdel;
        p[vj] = vi;
        mark_dirty(s, vj / chunk);
      }
    }
    if (__syncthreads_or(cand)) {
      const int32_t stamp = static_cast<int32_t>(step) + 1;
      if (threadIdx.x == 0) {
        // vi's chain up to and with the root; a tree built by this loop is
        // acyclic, and the bound keeps a malformed p from hanging the card
        int32_t x = vi;
        for (long long hop = 0; hop <= nvp; ++hop) {
          mark[x] = stamp;
          if (x <= 0) break;
          const int32_t px = p[x];
          x = px < 0 ? 0 : px;
        }
      }
      __syncthreads();
      if (cand) {
        for (long long k = threadIdx.x; k < width; k += kLoopThreads) {
          const int32_t vj = pd[base + k];
          if (vj < 0 || vj >= nvp || !(vj == vi || in_tree[vj])) continue;
          const float dn = __fadd_rn(pphi[base + k], dvi);
          const float cdel = pdelta[base + k];
          if (dn <= __fadd_rn(d[vj], kEps) && cdel <= __fsub_rn(l[vj], kEps) &&
              mark[vj] != stamp) {
            p[vj] = vi;
            d[vj] = dn;
            l[vj] = cdel;
          }
        }
      }
      __syncthreads();
    }
    recompute_dirty(s, in_tree, l, chunk, nvp);
    __syncthreads();
    if (threadIdx.x == 0) s.ndirty = 0;
  }
}

// The loops' latency floor: `steps` x (one block barrier + one dependent L2
// load), the part of a step no design of one block can avoid.  Thread 0
// follows the cycle `next` (through L2: ld.global.cg) and shares each hop.
__global__ void __launch_bounds__(kLoopThreads, 1)
loop_floor_kernel(const int32_t* __restrict__ next, int32_t* out,
                  long long steps) {
  __shared__ int32_t x;
  if (threadIdx.x == 0) x = 0;
  __syncthreads();
  for (long long step = 0; step < steps; ++step) {
    if (threadIdx.x == 0) x = __ldcg(next + x);
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = x;
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

// Prim's whole step loop in one launch: updates best, bp, in_tree (nvp + 2
// entries each) in place.  pd / pw are the (nvp, width) padded out-rows.
int segment_prim_loop(int device, const void* pd, const void* pw, void* best,
                      void* bp, void* in_tree, long long nvp, long long width,
                      long long steps, int chunk, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nvp <= 0 || width <= 0 || chunk <= 0 || (nvp + chunk - 1) / chunk > kMaxChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  prim_loop_kernel<<<1, kLoopThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pd), static_cast<const float*>(pw),
      static_cast<float*>(best), static_cast<int32_t*>(bp),
      static_cast<bool*>(in_tree), nvp, width, steps, chunk);
  return static_cast<int>(cudaGetLastError());
}

// Modified Prim's whole step loop in one launch: updates l, d, p, in_tree
// (nvp + 2 entries each) in place; *bound is theta + CONSTRAINT_TOL in f32;
// mark is nvp + 2 int32 zeros of scratch.
int segment_mp_loop(int device, const void* pd, const void* pdelta,
                    const void* pphi, const void* bound, void* l, void* d,
                    void* p, void* in_tree, void* mark, long long nvp,
                    long long width, long long steps, int chunk, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nvp <= 0 || width <= 0 || chunk <= 0 || (nvp + chunk - 1) / chunk > kMaxChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  mp_loop_kernel<<<1, kLoopThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pd), static_cast<const float*>(pdelta),
      static_cast<const float*>(pphi), static_cast<const float*>(bound),
      static_cast<float*>(l), static_cast<float*>(d), static_cast<int32_t*>(p),
      static_cast<bool*>(in_tree), static_cast<int32_t*>(mark), nvp, width,
      steps, chunk);
  return static_cast<int>(cudaGetLastError());
}

// The loops' latency floor over `steps` steps (see loop_floor_kernel); next
// is an int32 cycle, *out receives where it ended.
int segment_loop_floor(int device, const void* next, void* out,
                       long long steps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  loop_floor_kernel<<<1, kLoopThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(next), static_cast<int32_t*>(out), steps);
  return static_cast<int>(cudaGetLastError());
}

const char* segment_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
