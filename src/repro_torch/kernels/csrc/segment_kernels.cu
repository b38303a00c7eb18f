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
// The min orders -0.0 below +0.0 (a row holding both zeros gives -0.0,
// whatever their order), the argmin holds them equal; min_argmin_1d's value
// is x[i], the element at the first argmin, as the JAX package's XLA form.
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
// Design.  The reductions compare 32-bit integer keys, not floats (min_key:
// NaN and the sign of zero folded into one integer order).
// Rows: one template, rows_kernel<MinOp> / rows_kernel<ArgminOp> (the TPU's
// one _row_call with its _min_kernel and _argmin_kernel bodies).  A row gets
// L = clamp(pow2(width / 4), 1, 32) lanes, so a warp reduces 32 / L rows
// side by side, and each thread loads one 16-byte vector (ld.global.cs: read
// once) of each of Op::kUnroll rows before it reduces any (4 for the min, 2
// for the argmin, whose compare costs more: the fastest on an H100); then a
// __shfl_xor_sync butterfly over the L lanes.  Widths that are not a
// multiple of 4 and views that are not 16-byte aligned take the same kernel
// with 4-byte loads.  The grid is the card's resident blocks (SMs x blocks
// an SM holds, read once) at most, and strides over the rows.
// 1d: one launch a call.  Each block reduces its grid-strided share (16-byte
// loads in chunks of kUnroll1d in flight; the 0-3 elements before the first
// 16-byte boundary and the tail after the last whole vector as scalars),
// writes its (key, index, value) to a workspace, and takes a ticket (one
// acquire-release atomInc); the last block to finish reduces the parts,
// writes the result, and its atomInc wraps the ticket back to 0 for the
// next call.  The grid puts every load in flight at once where the resident
// blocks allow, but spreads over the SMs first (a vector a thread).  The
// wrapper keeps one workspace per (device, stream), zeroed once, so a call
// neither allocates scratch nor sets memory, two streams never share a
// ticket, and one stream's calls run in order.  At 2**20 one launch's floor
// (an empty kernel, ~2 us) is above the bytes bound; the rest is the
// latency chain of load, block reduction, ticket and the last block.
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

#include <algorithm>
#include <atomic>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;     // the row reduction's blocks
constexpr int kWarps = kThreads / kWarp;
constexpr int kThreads1d = 256;   // the 1d reduction's blocks
constexpr int kWarps1d = kThreads1d / kWarp;
constexpr int kUnroll1d = 4;      // 16-byte loads in flight a thread, 1d
constexpr int kMaxDevices = 64;
constexpr long long kPartsOffset = 16;  // the 1d workspace: ticket, then parts
constexpr float kEps = 1e-15f;        // repro_torch.kernels.ref.EPS
constexpr int kLoopThreads = 1024;    // the loops' one block
constexpr int kLoopWarps = kLoopThreads / kWarp;
constexpr int kMaxChunks = 2048;      // chunk minima held in shared memory

// ------------------------------------------------------------ order keys
// min_key orders as XLA's min: every NaN one key (INT32_MIN) below -inf,
// then the floats in order, -0.0 (key -1) below +0.0 (key 0).  Flipping the
// magnitude bits of a negative float makes the integer order the float
// order; the map is its own inverse (key_value).
__device__ __forceinline__ int32_t min_key(float x) {
  const int32_t b = __float_as_int(x);
  return isnan(x) ? INT32_MIN : b ^ ((b >> 31) & 0x7fffffff);
}

// The argmin's key: min_key with -0.0 and +0.0 one key, so the first wins.
__device__ __forceinline__ int32_t arg_key(float x) {
  const int32_t k = min_key(x);
  return k == -1 ? 0 : k;
}

__device__ __forceinline__ float key_value(int32_t k) {
  return k == INT32_MIN ? __int_as_float(0x7fc00000)  // NaN
                        : __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// True when (a, ia) precedes (b, ib): NaN first, then the smaller value;
// equal values (or two NaNs) go to the smaller index.  The loops' order.
__device__ __forceinline__ bool precedes(float a, int32_t ia, float b,
                                         int32_t ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && (!bn || ia < ib);
  return a < b || (a == b && ia < ib);
}

// ------------------------------------------------------- row reduction
// The template's two bodies.  take() sees a thread's columns in increasing
// order, so a strict compare keeps the first of a tie; merge_lanes() folds
// in lane (lane ^ off) of the row's lanes.
struct MinOp {
  using Out = float;
  static constexpr int kUnroll = 4;  // rows a thread loads before it reduces
  struct Acc {
    int32_t key;
  };
  static __device__ __forceinline__ Acc identity() { return {INT32_MAX}; }
  static __device__ __forceinline__ void take(Acc& a, float x, int32_t) {
    a.key = min(a.key, min_key(x));
  }
  static __device__ __forceinline__ void merge_lanes(Acc& a, int off) {
    a.key = min(a.key, __shfl_xor_sync(0xffffffffu, a.key, off));
  }
  static __device__ __forceinline__ Out result(const Acc& a) {
    return key_value(a.key);
  }
};

struct ArgminOp {
  using Out = int32_t;
  static constexpr int kUnroll = 2;  // its compare costs more: fewer rows
  struct Acc {
    int32_t key, idx;
  };
  static __device__ __forceinline__ Acc identity() {
    return {INT32_MAX, INT32_MAX};
  }
  static __device__ __forceinline__ void take(Acc& a, float x, int32_t col) {
    const int32_t k = arg_key(x);
    if (k < a.key) {
      a.key = k;
      a.idx = col;
    }
  }
  static __device__ __forceinline__ void merge_lanes(Acc& a, int off) {
    const int32_t k = __shfl_xor_sync(0xffffffffu, a.key, off);
    const int32_t i = __shfl_xor_sync(0xffffffffu, a.idx, off);
    if (k < a.key || (k == a.key && i < a.idx)) {
      a.key = k;
      a.idx = i;
    }
  }
  static __device__ __forceinline__ Out result(const Acc& a) { return a.idx; }
};

// One 16-byte or one 4-byte streaming load (read once: evict first).
__device__ __forceinline__ void load_cs(const float* p, float (&v)[4]) {
  const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load_cs(const float* p, float (&v)[1]) {
  v[0] = __ldcs(p);
}

// A warp takes Op::kUnroll groups of 32 / L rows at a time; lane c of a row's
// L lanes reads its vectors c, c + L, ... of V floats.  Every lane reaches
// the butterfly (no early exit), so full-mask shuffles are safe.
template <class Op, int V>
__device__ __forceinline__ void reduce_rows(const float* __restrict__ x,
                                            typename Op::Out* __restrict__ out,
                                            long long rows, long long width,
                                            int lanes_log2) {
  const int lane = threadIdx.x % kWarp;
  const int lanes = 1 << lanes_log2;
  const int sub = lane >> lanes_log2, c = lane & (lanes - 1);
  const long long group = kWarp >> lanes_log2;  // rows side by side a warp
  const long long step = group * Op::kUnroll;    // rows a warp takes at a time
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  const long long nv = width / V;               // vectors a row
  for (long long r0 = (static_cast<long long>(blockIdx.x) * kWarps +
                       threadIdx.x / kWarp) * step;
       r0 < rows; r0 += warps * step) {
    typename Op::Acc acc[Op::kUnroll];
#pragma unroll
    for (int u = 0; u < Op::kUnroll; ++u) acc[u] = Op::identity();
    for (long long k = c; k < nv; k += lanes) {
      float v[Op::kUnroll][V];
#pragma unroll
      for (int u = 0; u < Op::kUnroll; ++u) {
        const long long r = r0 + u * group + sub;
        if (r < rows) {
          load_cs(x + r * width + k * V, v[u]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) v[u][j] = INFINITY;
        }
      }
#pragma unroll
      for (int u = 0; u < Op::kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j)
          Op::take(acc[u], v[u][j], static_cast<int32_t>(k * V + j));
    }
#pragma unroll
    for (int u = 0; u < Op::kUnroll; ++u)
      for (int off = lanes >> 1; off > 0; off >>= 1) Op::merge_lanes(acc[u], off);
#pragma unroll
    for (int u = 0; u < Op::kUnroll; ++u) {
      const long long r = r0 + u * group + sub;
      if (c == 0 && r < rows) out[r] = Op::result(acc[u]);
    }
  }
}

// vec: width % 4 == 0 and x 16-byte aligned (every row then is).
template <class Op>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const float* __restrict__ x, typename Op::Out* __restrict__ out,
            long long rows, long long width, int lanes_log2, int vec) {
  if (vec)
    reduce_rows<Op, 4>(x, out, rows, width, lanes_log2);
  else
    reduce_rows<Op, 1>(x, out, rows, width, lanes_log2);
}

// ------------------------------------------------------ 1d reduction
// The running (key, first index) and the element itself: the result's value
// is x[i], with its own sign of zero and NaN bits.
struct Best {
  int32_t key, idx;
  float val;
};

__device__ __forceinline__ Best no_best() { return {INT32_MAX, INT32_MAX, 0.0f}; }

// x is element i; a thread meets its elements in increasing order.
__device__ __forceinline__ void take(Best& b, float x, int32_t i) {
  const int32_t k = arg_key(x);
  if (k < b.key) {
    b.key = k;
    b.idx = i;
    b.val = x;
  }
}

__device__ __forceinline__ void merge(Best& b, const Best& o) {
  if (o.key < b.key || (o.key == b.key && o.idx < b.idx)) b = o;
}

__device__ __forceinline__ void merge_lanes(Best& b, int off) {
  Best o;
  o.key = __shfl_xor_sync(0xffffffffu, b.key, off);
  o.idx = __shfl_xor_sync(0xffffffffu, b.idx, off);
  o.val = __shfl_xor_sync(0xffffffffu, b.val, off);
  merge(b, o);
}

// The block's best, in thread 0; one barrier.  All threads call it.
__device__ __forceinline__ Best block_best(Best b) {
  __shared__ Best s[kWarps1d];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int off = kWarp / 2; off > 0; off >>= 1) merge_lanes(b, off);
  if (lane == 0) s[warp] = b;
  __syncthreads();
  if (warp == 0) {
    b = lane < kWarps1d ? s[lane] : no_best();
    for (int off = kWarps1d / 2; off > 0; off >>= 1) merge_lanes(b, off);
  }
  return b;
}

// The best of this thread's grid-strided share of x[0, n).  The first
// `head` elements (before x + head is 16-byte aligned) and the tail after
// the last whole vector are scalars, one a thread; the vectors in between
// are 16-byte loads in chunks of kUnroll1d, all of a chunk in flight (a
// partial chunk too: its loads are predicated, not looped).
__device__ __forceinline__ Best share_best(const float* __restrict__ x,
                                           long long n, int head) {
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads1d + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads1d;
  const long long nv = (n - head) / 4;   // whole vectors after the head
  const long long tail = head + 4 * nv;  // the first element after them
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  Best b = no_best();
  if (tid < head) take(b, x[tid], static_cast<int32_t>(tid));
  for (long long v = tid; v < nv; v += kUnroll1d * stride) {
    float4 t[kUnroll1d];
#pragma unroll
    for (int u = 0; u < kUnroll1d; ++u)
      if (v + u * stride < nv) t[u] = __ldcs(xv + v + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll1d; ++u) {
      if (v + u * stride >= nv) continue;
      const int32_t i = static_cast<int32_t>(head + 4 * (v + u * stride));
      take(b, t[u].x, i);
      take(b, t[u].y, i + 1);
      take(b, t[u].z, i + 2);
      take(b, t[u].w, i + 3);
    }
  }
  if (tail + tid < n) take(b, x[tail + tid], static_cast<int32_t>(tail + tid));
  return b;
}

// True for the last of `count` takers.  One acquire-release atomic at the
// device's scope: it releases the part this thread wrote before it, and the
// last taker acquires every part released before; its block's other threads
// read them after a barrier.  The last ticket wraps the counter to 0
// (atom.inc), so the next call starts clean.
__device__ __forceinline__ bool take_ticket(unsigned int* ticket, unsigned count) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(ticket), "r"(count - 1)
               : "memory");
  return old == count - 1;
}

// The best of parts[0, count), written by other blocks, in thread 0.
__device__ __forceinline__ Best parts_best(const Best* parts, unsigned count) {
  Best p = no_best();
  for (unsigned j = threadIdx.x; j < count; j += kThreads1d) {
    Best o;  // read through L2, never a stale L1 line
    o.key = __ldcg(&parts[j].key);
    o.idx = __ldcg(&parts[j].idx);
    o.val = __ldcg(&parts[j].val);
    merge(p, o);
  }
  return block_best(p);
}

__device__ __forceinline__ void write_best(const Best& p, long long n,
                                           float* out_val, int32_t* out_idx) {
  *out_val = p.val;
  // the JAX form's clamp of the padded flat index, jnp.minimum(i, n - 1)
  *out_idx = p.idx < n - 1 ? p.idx : static_cast<int32_t>(n - 1);
}

// (min, first argmin) of x[0, n) in one launch: each block's best goes to
// parts, and the block that takes the last ticket reduces them.
__global__ void __launch_bounds__(kThreads1d)
argmin_1d_kernel(const float* __restrict__ x, long long n, int head,
                 unsigned int* ticket, Best* parts, float* __restrict__ out_val,
                 int32_t* __restrict__ out_idx) {
  const Best b = block_best(share_best(x, n, head));
  __shared__ bool last;
  if (threadIdx.x == 0) {
    parts[blockIdx.x] = b;
    last = take_ticket(ticket, gridDim.x);
  }
  __syncthreads();
  if (!last) return;
  const Best p = parts_best(parts, gridDim.x);
  if (threadIdx.x == 0) write_best(p, n, out_val, out_idx);
}

__global__ void empty_kernel() {}

// Blocks of `kernel` the card runs at once (SMs x the blocks an SM holds)
// and its SMs, read once a device: cache[device] = blocks << 16 | SMs.
template <class Kernel>
cudaError_t card_blocks(int device, Kernel kernel, int threads,
                        std::atomic<int> (&cache)[kMaxDevices], long long& blocks,
                        long long& sms) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int have = cache[device].load();
  if (have == 0) {
    int n_sm = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    if (err != cudaSuccess) return err;
    have = (n_sm * (per_sm < 1 ? 1 : per_sm)) << 16 | n_sm;
    cache[device].store(have);
  }
  blocks = have >> 16;
  sms = have & 0xffff;
  return cudaSuccess;
}

std::atomic<int> g_min_rows_blocks[kMaxDevices];
std::atomic<int> g_argmin_rows_blocks[kMaxDevices];
std::atomic<int> g_1d_blocks[kMaxDevices];

template <class Op>
int launch_rows(int device, const void* x, void* out, long long rows,
                long long width, void* stream,
                std::atomic<int> (&cache)[kMaxDevices]) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows > 0) {
    const int vec = width % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const long long loads = vec ? width / 4 : width;  // vectors a row
    int lanes_log2 = 0;
    while (lanes_log2 < 5 && (1LL << lanes_log2) < loads) ++lanes_log2;
    const long long per_block =
        static_cast<long long>(kWarps) * (kWarp >> lanes_log2) * Op::kUnroll;
    long long card = 0, sms = 0;
    err = card_blocks(device, rows_kernel<Op>, kThreads, cache, card, sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    long long grid = (rows + per_block - 1) / per_block;
    if (grid > card) grid = card;
    rows_kernel<Op><<<static_cast<unsigned>(grid), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<typename Op::Out*>(out), rows,
        width, lanes_log2, vec);
  }
  return static_cast<int>(cudaGetLastError());
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
  return launch_rows<MinOp>(device, x, out, rows, width, stream,
                            g_min_rows_blocks);
}

// out[r] = int32 index of the first minimum of row r.
int segment_argmin_rows(int device, const void* x, void* out, long long rows,
                        long long width, void* stream) {
  return launch_rows<ArgminOp>(device, x, out, rows, width, stream,
                               g_argmin_rows_blocks);
}

// (*out_val, *out_idx) = (x[i], i) for i the first argmin of the n-element
// f32 vector x, in one launch.  workspace: `workspace_bytes` bytes, zeroed
// before its first use and kept for this stream's calls alone.
int segment_min_argmin_1d(int device, const void* x, void* out_val,
                          void* out_idx, void* workspace, long long n,
                          long long workspace_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long max_parts =
      (workspace_bytes - kPartsOffset) / static_cast<long long>(sizeof(Best));
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  if (n <= 0 || n > INT32_MAX || max_parts < 1 || addr % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  long long head = static_cast<long long>((16 - addr % 16) % 16) / 4;
  if (head > n) head = n;
  const long long nv = (n - head) / 4;
  long long grid = 0, sms = 0;
  err = card_blocks(device, argmin_1d_kernel, kThreads1d, g_1d_blocks, grid, sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Every load in flight at once where the resident blocks allow (whole
  // chunks), but spread over the SMs first: a vector a thread before a
  // chunk a thread.
  const long long whole = (nv + kThreads1d * kUnroll1d - 1) / (kThreads1d * kUnroll1d);
  const long long spread = (nv + kThreads1d - 1) / kThreads1d;
  const long long target = std::max(whole, sms);
  grid = std::max(1LL, std::min({grid, target, spread, max_parts}));
  char* ws = static_cast<char*>(workspace);
  argmin_1d_kernel<<<static_cast<unsigned>(grid), kThreads1d, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, static_cast<int>(head),
      reinterpret_cast<unsigned int*>(ws), reinterpret_cast<Best*>(ws + kPartsOffset),
      static_cast<float*>(out_val), static_cast<int32_t*>(out_idx));
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

// One empty kernel: the floor under any launch of this library.
int segment_launch_floor(int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  empty_kernel<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* segment_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
