// Hand-written CUDA forward attention for the dense-LM prefill (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package's serving path,
// src/repro/kernels/flash_attention.py flash_attention (_flash_kernel,
// pl.pallas_call), reached from models/attention.py _full_attention during
// prefill.  It computes what _flash_kernel computes, row for row:
//
//   qs  = bf16(f32(q) * scale)                 (scaled in f32, rounded back)
//   s   = qs . k^T                             (bf16 operands, f32 sums)
//   s   = NEG_INF where key > query position   (causal, global positions;
//                                               NEG_INF = -0.7 * FLT_MAX)
//   online softmax over key tiles: m, l and the output accumulator in f32,
//   p = exp(s - m) rounded to bf16 for the PV product, l summing f32 p;
//   out = bf16(acc / max(l, 1e-30))
//
// GQA: query head h reads KV head h / g (g = H / KV, at most 64).  As in
// the JAX kernel the group is folded into the query rows: folded row r of KV
// head kv is query position r / g of head kv * g + r % g.  The kernel reads
// q, k, v and writes o through their (batch, sequence, head) strides, so
// nothing is transposed or copied in device memory.
//
// Bound.  Causal attention does 4 * B * H * hd * Sq * (Sq + 1) / 2 flops of
// bf16 products and reads Q, K, V and writes O once: at the serving shape
// (B 8, S 2048, H 24, KV 8, hd 128) 2.06e11 flops, 0.21 ms at 989 TFLOP/s,
// against 0.08 ms of bytes at 3.35 TB/s, so the tensor cores bound it.
//
// Design, the shape of a Hopper GEMM kernel:
//
// * Persistent: one CTA of three warpgroups (384 threads) per SM.  A work
//   tile is 2 Pw positions of one (batch, KV head), Pw = floor(64 / g) for
//   each consumer warpgroup, so each half is Pw * g <= 64 folded rows that
//   form one rectangular box (positions x heads x hd) of q and of o.  Tiles
//   are numbered heaviest causal row block first within groups of
//   (batch, KV head) pairs whose K and V fit in L2 together, and handed out
//   by a global counter (the first wave by blockIdx), so the CTAs resident
//   at one time share K/V tiles through L2 and the tail stays short.
// * Warpgroup 0 is the producer: it gives up registers (setmaxnreg) and one
//   thread takes the tiles and issues every load by TMA, 128-byte swizzled
//   (64-byte at hd 32) as 4-D boxes over (hd, head, position, batch) with
//   the tensors' own strides, zero-filled past the end: Q into one of two
//   buffers (the next tile's while this one runs), K and V into rings of
//   two stages each, with full and empty mbarriers per stage.
// * Warpgroups 1 and 2 are consumers of one half each, with 240 registers
//   a thread.  Each scales its Q rows in f32 and rounds them to bf16 in
//   place, then fences the generic proxy against the async proxy.
// * S = Q K^T is wgmma m64n128k16 with both operands in shared memory
//   (K is K-major as stored).  The scores stay in registers; the softmax
//   turns them into P, repacked in registers as the A operand of O += P V,
//   a wgmma m64n{hd}k16 with V read MN-major through the descriptor's
//   transpose bit.  For key tile t > 0 a consumer issues S of t and the PV
//   product of t - 1 as two groups, waits for S only and runs the softmax
//   of t while the PV product is on the tensor cores.  Key tile 0 is peeled
//   off the loop: with the PV group under a branch in the loop, ptxas
//   serialises every product of the loop (warning C7514).
//   The two consumers run free: FlashAttention-3's ping-pong (named
//   barriers making them take turns on the tensor cores) measured no
//   faster on an H100, and neither did waiting for both products before
//   the softmax (tests/torch_kernel_ablation_check.py times both).  The
//   causal mask is applied only on the tiles that cross the half's
//   diagonal or the end of the keys.
// * The output is staged in the consumer's own (no longer needed) Q rows
//   and written by one TMA store per half (positions past Sq are clipped);
//   the buffer is released once the store has read it out.
//
// Arithmetic is fused (FMA) and exp is ex2.approx on a log2(e)-scaled
// argument; p and the output round to bf16 where the JAX kernel rounds.
// Nothing here allocates or synchronises with the host; the entry point
// encodes the four tensor maps, launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 128;    // rows of a Q buffer: two halves of 64
constexpr int kWgRows = 64;     // rows per consumer warpgroup
constexpr int kBlockN = 128;    // keys per tile
constexpr int kStages = 2;      // ring depth of K and of V
constexpr int kThreads = 384;   // producer + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr long long kL2GroupBytes = 16LL << 20;  // K + V of one CTA group
constexpr float kNegInf = -0.7f * 3.40282346638528859812e+38f;  // NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory geometry of one head dim.  A "box" is a column slice of a
// tile as wide as the swizzle (64 bf16 = 128 bytes; 32 bf16 = 64 bytes at
// hd 32), rows contiguous, 8-row groups of 8 * kRowBytes bytes.
template <int HD>
struct Geom {
  static constexpr int kRowBytes = HD >= 64 ? 128 : 2 * HD;
  static constexpr int kBoxCols = kRowBytes / 2;
  static constexpr int kBoxes = HD / kBoxCols;
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;  // wgmma: B128 / B64
  static constexpr uint32_t kSwzMask = kRowBytes == 128 ? 7 : 3;
  static constexpr int kQBox = kBlockM * kRowBytes;
  static constexpr int kKVBox = kBlockN * kRowBytes;
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kTileBytes = kBoxes * kKVBox;  // one K or V tile
  static constexpr int kBarBytes = (4 * kStages + 4) * 8 + 8;  // mbarriers, tile_of[2]
  static constexpr int kSmem = 1024 + 2 * kQBytes + 2 * kStages * kTileBytes + kBarBytes;
  // byte offset (from a 1024-aligned base) -> its swizzled position, as TMA
  // writes it and wgmma reads it: the 16-byte chunk index XOR the row bits
  static __device__ __forceinline__ uint32_t swz(uint32_t off) {
    return off ^ (((off >> 7) & kSwzMask) << 4);
  }
};

struct Params {
  int Sq, Sk, KV, g;
  int Pw;                      // positions per consumer warpgroup: Pw * g <= 64 rows
  int n_rb, bkv, group;        // row blocks, batch * KV, pairs per L2 group
  int total;                   // work tiles: n_rb * bkv
  int* next;                   // work tiles handed out past the first wave (zeroed)
  float scale;
  int causal;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- mbarriers and TMA
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

// wait until the barrier has completed the phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- named barrier (0 is __syncthreads): 3 + c is consumer c's own
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

// ---- wgmma
// Matrix descriptor: start address >> 4 (bits 0-13), leading byte offset
// >> 4 (16-29), stride byte offset >> 4 (32-45), swizzle mode (62-63).
// K-major swizzled operands ignore the leading offset; the stride offset is
// the distance between 8-row groups.  For the MN-major V the leading offset
// is the distance between two 64-column boxes.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | layout << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// wait until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d (64 x 128, f32) {+}= a (64 x 16, smem) * b (128 x 16, smem); both K-major
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, f32) += a (64 x 16, registers) * b (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) += a (64 x 16, registers) * b (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32, f32) += a (64 x 16, registers) * b (16 x 32, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int HD>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a, uint64_t db) {
  if constexpr (HD == 128) {
    wgmma_rs_n128(o, a, db);
  } else if constexpr (HD == 64) {
    wgmma_rs_n64(o, a, db);
  } else {
    wgmma_rs_n32(o, a, db);
  }
}

// byte offset of k-step kk (16 columns) in a tile whose boxes are box_bytes apart
template <int HD>
__device__ __forceinline__ uint32_t kstep_offset(int kk, int box_bytes) {
  constexpr int kSteps = Geom<HD>::kBoxCols / 16;  // k-steps per box
  return (kk / kSteps) * box_bytes + (kk % kSteps) * 32;
}

// One work tile: the rows of 2 * p.Pw positions of one (batch, KV head),
// p.Pw positions (Pw * g <= 64 folded rows) for each consumer warpgroup.
// Work tile w: pairs of (batch, KV head) come in groups of p.group, whose K
// and V fit in L2 together; within a group the heaviest row blocks come
// first.
struct Tile {
  int b, kvh, p0, n_tiles;
};

__device__ __forceinline__ Tile decode_tile(const Params& p, int w) {
  const int per_group = p.group * p.n_rb;
  const int grp = w / per_group, rem = w % per_group;
  const int gsz = min(p.group, p.bkv - grp * p.group);
  const int bh = grp * p.group + rem % gsz;
  Tile t;
  t.b = bh / p.KV;
  t.kvh = bh % p.KV;
  t.p0 = (p.n_rb - 1 - rem / gsz) * 2 * p.Pw;
  t.n_tiles = (p.Sk + kBlockN - 1) / kBlockN;
  if (p.causal)  // up to the key tile of the block's last position
    t.n_tiles = min(t.n_tiles, (min(t.p0 + 2 * p.Pw, p.Sq) - 1) / kBlockN + 1);
  return t;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tmap_q,
                 const __grid_constant__ CUtensorMap tmap_k,
                 const __grid_constant__ CUtensorMap tmap_v,
                 const __grid_constant__ CUtensorMap tmap_o, const Params p) {
  using G = Geom<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;  // swizzle atoms are 1 KiB; two Q buffers
  const uint32_t sK = sQ + 2 * G::kQBytes;
  const uint32_t sV = sK + kStages * G::kTileBytes;
  const uint32_t bars = sV + kStages * G::kTileBytes;
  const uint32_t full_k = bars, full_v = bars + 8 * kStages;
  const uint32_t empty_k = bars + 16 * kStages, empty_v = bars + 24 * kStages;
  const uint32_t q_full = bars + 32 * kStages, q_empty = q_full + 16;
  volatile int* tile_of = reinterpret_cast<volatile int*>(smem_raw + (q_empty + 16 - raw));
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  constexpr int kBoxChunks = G::kBoxCols / 8;
  constexpr int kPerThread = kWgRows * kChunks / 128;
  const int rows = p.Pw * p.g;  // folded rows of a warpgroup's half of a tile

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 8);  // one arrival per consumer warp
      mbar_init(empty_v + 8 * s, 8);
    }
    for (int x = 0; x < 2; ++x) {
      mbar_init(q_full + 8 * x, 1);
      mbar_init(q_empty + 8 * x, 2);  // each consumer's store has read it out
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 0) {
    // ---- producer: one thread takes the work tiles (the first from
    // blockIdx.x, then from the global counter) and loads, by TMA, each
    // tile's Q into buffer k & 1 and its K and V through the rings
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(kProducerRegs));
    if (tid == 0) {
      uint32_t it = 0;  // key tiles loaded so far
      for (int k = 0;; ++k) {
        const int buf = k & 1;
        if (k >= 2) mbar_wait(q_empty + 8 * buf, ((k >> 1) - 1) & 1);
        const int w = k == 0 ? blockIdx.x : atomicAdd(p.next, 1) + gridDim.x;
        tile_of[buf] = w;
        if (w >= p.total) {
          mbar_arrive(q_full + 8 * buf);  // no tile: the consumers stop
          break;
        }
        const Tile tl = decode_tile(p, w);
        mbar_expect_tx(q_full + 8 * buf, 2 * G::kBoxes * rows * G::kRowBytes);
#pragma unroll
        for (int h = 0; h < 2; ++h)  // each consumer's half, from row 64 h
#pragma unroll
          for (int x = 0; x < G::kBoxes; ++x)
            tma_load_4d(sQ + buf * G::kQBytes + x * G::kQBox + h * kWgRows * G::kRowBytes,
                        &tmap_q, q_full + 8 * buf, x * G::kBoxCols, tl.kvh * p.g,
                        tl.p0 + h * p.Pw, tl.b);
        for (int t = 0; t < tl.n_tiles; ++t, ++it) {
          const int s = it % kStages;
          const uint32_t lap = (it / kStages) & 1;
          if (it >= kStages) mbar_wait(empty_k + 8 * s, lap ^ 1);
          mbar_expect_tx(full_k + 8 * s, G::kTileBytes);
#pragma unroll
          for (int x = 0; x < G::kBoxes; ++x)
            tma_load_4d(sK + s * G::kTileBytes + x * G::kKVBox, &tmap_k, full_k + 8 * s,
                        x * G::kBoxCols, tl.kvh, t * kBlockN, tl.b);
          if (it >= kStages) mbar_wait(empty_v + 8 * s, lap ^ 1);
          mbar_expect_tx(full_v + 8 * s, G::kTileBytes);
#pragma unroll
          for (int x = 0; x < G::kBoxes; ++x)
            tma_load_4d(sV + s * G::kTileBytes + x * G::kKVBox, &tmap_v, full_v + 8 * s,
                        x * G::kBoxCols, tl.kvh, t * kBlockN, tl.b);
        }
      }
    }
  } else {
    // ---- consumers: one half (64 rows) each of every work tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(kConsumerRegs));
    const int c = wg - 1;
    const int t128 = tid - 128 * wg;
    const int warp = t128 >> 5, lane = t128 & 31;
    const int col0 = 2 * (lane & 3);
    const int lr_a = warp * 16 + (lane >> 2);  // this thread's rows a, b = a + 8 of its half
    const uint64_t dk = make_desc(sK, 16, 8 * G::kRowBytes, G::kLayout);
    const uint64_t dv = make_desc(sV, G::kKVBox, 8 * G::kRowBytes, G::kLayout);
    uint32_t it = 0;  // key tiles consumed so far (the rings' position)
    int stored = -1;  // the buffer whose output store is in flight

    for (int k = 0;; ++k) {
      const int buf = k & 1;
      mbar_wait(q_full + 8 * buf, (k >> 1) & 1);
      const int w = tile_of[buf];
      if (w >= p.total) break;
      const Tile tl = decode_tile(p, w);
      const uint32_t sQb = sQ + buf * G::kQBytes;

      // q arrived raw: scale it in f32 and round to bf16 once, in place
      // (this warpgroup's rows; rows past its half's end are not used)
#pragma unroll
      for (int i8 = 0; i8 < kPerThread; ++i8) {
        const int i = t128 + 128 * i8, row = c * kWgRows + i / kChunks, ch = i % kChunks;
        const uint32_t a = sQb + G::swz((ch / kBoxChunks) * G::kQBox + row * G::kRowBytes +
                                        (ch % kBoxChunks) * 16);
        uint32_t v[4];
        asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
                     : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3]) : "r"(a) : "memory");
#pragma unroll
        for (int x = 0; x < 4; ++x)  // two bf16 a word: the low one first
          v[x] = pack_bf16(__uint_as_float(v[x] << 16) * p.scale,
                           __uint_as_float(v[x] & 0xffff0000u) * p.scale);
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};"
                     :: "r"(a), "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]) : "memory");
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to wgmma
      bar_sync(3 + c, 128);
      const uint64_t dq = make_desc(sQb + c * kWgRows * G::kRowBytes, 16, 8 * G::kRowBytes,
                                    G::kLayout);

      float o[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
      float sc[kBlockN / 2];         // S, then P in f32: rows a and b, 64 columns
      uint32_t pa[kBlockN / 16][4];  // P in bf16 as the PV product's A fragments
      float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
      const int pos_min = tl.p0 + c * p.Pw;  // the first position of this half
      const int pos_a = pos_min + lr_a / p.g, pos_b = pos_min + (lr_a + 8) / p.g;

      // The softmax of key tile t over this thread's S registers: masks
      // (only on tiles that cross the diagonal or the end of the keys),
      // updates m and l, leaves exp(s - m) in sc and the rescale factors.
      float corr_a, corr_b;
      auto softmax = [&](int t) {
        const int n0 = t * kBlockN;
        if ((p.causal && n0 + kBlockN - 1 > pos_min) || n0 + kBlockN > p.Sk) {
#pragma unroll
          for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = n0 + 8 * j + col0 + (e & 1);
              const int pos = e < 2 ? pos_a : pos_b;
              if (key >= p.Sk || (p.causal && key > pos)) sc[4 * j + e] = kNegInf;
            }
          }
        }
        float mx_a = m_a, mx_b = m_b;
#pragma unroll
        for (int j = 0; j < kBlockN / 8; ++j) {
          mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
        corr_a = ex2((m_a - mx_a) * kLog2e);
        corr_b = ex2((m_b - mx_b) * kLog2e);
        m_a = mx_a;
        m_b = mx_b;
        // exp(s - m) = 2^(s log2e - m log2e); a row that has seen no key yet
        // (m still NEG_INF) cannot occur, key 0 being visible to every row
        const float ms_a = m_a == kNegInf ? 0.f : m_a * kLog2e;
        const float ms_b = m_b == kNegInf ? 0.f : m_b * kLog2e;
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int j = 0; j < kBlockN / 8; ++j) {
          sc[4 * j] = ex2(fmaf(sc[4 * j], kLog2e, -ms_a));
          sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], kLog2e, -ms_a));
          sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], kLog2e, -ms_b));
          sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], kLog2e, -ms_b));
          sum_a += sc[4 * j] + sc[4 * j + 1];
          sum_b += sc[4 * j + 2] + sc[4 * j + 3];
        }
        l_a = l_a * corr_a + sum_a;
        l_b = l_b * corr_b + sum_b;
      };
      auto pack_p = [&] {  // P to bf16, as the PV product's A fragments
#pragma unroll
        for (int j = 0; j < kBlockN / 8; ++j) {
          pa[j >> 1][(j & 1) * 2] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
          pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
        }
      };
      auto issue_s = [&](int s) {  // S = Q K^T of the tile in stage s
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss_n128(sc, dq + (kstep_offset<HD>(kk, G::kQBox) >> 4),
                        dk + ((s * G::kTileBytes + kstep_offset<HD>(kk, G::kKVBox)) >> 4), kk > 0);
        wgmma_commit();
      };
      auto issue_pv = [&](int s) {  // O += P V of the tile in stage s
        wgmma_fence();
#pragma unroll
        for (int kt = 0; kt < kBlockN / 16; ++kt)
          wgmma_pv<HD>(o, pa[kt], dv + ((s * G::kTileBytes + kt * 16 * G::kRowBytes) >> 4));
        wgmma_commit();
      };

      {  // key tile 0: S alone
        const int s = it % kStages;
        mbar_wait(full_k + 8 * s, (it / kStages) & 1);
        issue_s(s);
        if (stored >= 0 && t128 == 0) {  // the last tile's output store has read out its
          asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");  // buffer
          mbar_arrive(q_empty + 8 * stored);
        }
        wgmma_wait<0>();
        fence_regs(sc);
        if (lane == 0) mbar_arrive(empty_k + 8 * s);
        softmax(0);
        pack_p();
        ++it;
      }
      // key tile t: S of t and the PV product of t - 1 are issued together;
      // the softmax of t runs while the PV product is on the tensor cores
      for (int t = 1; t < tl.n_tiles; ++t, ++it) {
        const int s = it % kStages, sp = (it + kStages - 1) % kStages;
        mbar_wait(full_k + 8 * s, (it / kStages) & 1);
        mbar_wait(full_v + 8 * sp, ((it - 1) / kStages) & 1);
        fence_regs(o);
        issue_s(s);
        issue_pv(sp);
        wgmma_wait<1>();
        fence_regs(sc);
        if (lane == 0) mbar_arrive(empty_k + 8 * s);
        softmax(t);
        wgmma_wait<0>();
        fence_regs(o);
        if (lane == 0) mbar_arrive(empty_v + 8 * sp);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          o[4 * j] *= corr_a;
          o[4 * j + 1] *= corr_a;
          o[4 * j + 2] *= corr_b;
          o[4 * j + 3] *= corr_b;
        }
        pack_p();
      }

      {  // O += P V of the last tile
        const int sp = (it - 1) % kStages;
        mbar_wait(full_v + 8 * sp, ((it - 1) / kStages) & 1);
        fence_regs(o);
        issue_pv(sp);
        wgmma_wait<0>();
        fence_regs(o);
        if (lane == 0) mbar_arrive(empty_v + 8 * sp);
      }

      // out = acc / max(l, 1e-30), staged in this warpgroup's own Q rows
      // (their last reader, the final S product, has completed), then one
      // TMA store of the half (positions past Sq are clipped)
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
      const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
      const uint32_t sO = sQb + c * kWgRows * G::kRowBytes;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int d = 8 * j + col0;
        const uint32_t off = (d / G::kBoxCols) * G::kQBox + lr_a * G::kRowBytes +
                             ((d % G::kBoxCols) / 8) * 16 + (d % 8) * 2;
        asm volatile("st.shared.b32 [%0], %1;"
                     :: "r"(sO + G::swz(off)), "r"(pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a))
                     : "memory");
        asm volatile("st.shared.b32 [%0], %1;"
                     :: "r"(sO + G::swz(off + 8 * G::kRowBytes)),
                        "r"(pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b))
                     : "memory");
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to the TMA store
      bar_sync(3 + c, 128);
      if (t128 == 0) {
#pragma unroll
        for (int x = 0; x < G::kBoxes; ++x)
          tma_store_4d(&tmap_o, sO + x * G::kQBox, x * G::kBoxCols, tl.kvh * p.g, pos_min, tl.b);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
      stored = buf;
    }
    if (t128 == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");  // writes done
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(ptr) : nullptr;
  }();
  return fn;
}

// The tensor map of q (B, Sq, H, hd) or k, v (B, Sk, KV, hd): dims (hd,
// heads, sequence, batch) with the tensor's byte strides; boxes of one
// swizzle width of hd, `heads_box` heads and `seq_box` positions.
cudaError_t encode_map(CUtensorMap* map, const void* ptr, long long hd, long long heads,
                       long long seq, long long batch, long long sh, long long ss, long long sb,
                       int heads_box, int seq_box) {
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(hd < 64 ? hd : 64),
                             static_cast<cuuint32_t>(heads_box), static_cast<cuuint32_t>(seq_box), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      hd >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD>
cudaError_t launch_flash(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                         const CUtensorMap& mo, const Params& p, int grid, cudaStream_t stream) {
  constexpr int bytes = Geom<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<HD><<<grid, kThreads, bytes, stream>>>(mq, mk, mv, mo, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// o (B, Sq, H, hd) = attention of q (B, Sq, H, hd) over k, v (B, Sk, KV, hd),
// all bf16 with the head dim contiguous; strides in elements, multiples of 8,
// and 16-byte aligned starts.  hd is 32, 64 or 128.  causal != 0 masks
// key > query position.  next: one int32, zero, the work-tile counter.
int attention_flash_fwd(int device, const void* q, const void* k, const void* v, void* o,
                        void* next,
                        long long batch, long long sq, long long sk, long long heads,
                        long long kv_heads, long long hd,
                        long long q_sb, long long q_ss, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        long long o_sb, long long o_ss, long long o_sh,
                        float scale, int causal, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || sq <= 0 || sk <= 0 || kv_heads <= 0 || heads % kv_heads ||
      heads / kv_heads > kWgRows || sq > (1LL << 30) || sk > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.Sq = static_cast<int>(sq);
  p.Sk = static_cast<int>(sk);
  p.KV = static_cast<int>(kv_heads);
  p.g = static_cast<int>(heads / kv_heads);
  p.Pw = kWgRows / p.g;
  p.n_rb = (p.Sq + 2 * p.Pw - 1) / (2 * p.Pw);
  const long long bkv = batch * kv_heads;
  if (bkv * p.n_rb >= (1LL << 31) - (1LL << 20)) return static_cast<int>(cudaErrorInvalidValue);
  p.bkv = static_cast<int>(bkv);
  p.total = static_cast<int>(bkv * p.n_rb);
  p.next = static_cast<int*>(next);
  const long long group = kL2GroupBytes / (4 * sk * hd);  // K + V bytes of one pair
  p.group = static_cast<int>(group < 1 ? 1 : (group > bkv ? bkv : group));
  p.scale = scale;
  p.causal = causal;
  int sms = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  const int grid = p.total < sms ? p.total : sms;  // persistent: one CTA per SM
  CUtensorMap mq, mk, mv, mo;
  if ((err = encode_map(&mq, q, hd, heads, sq, batch, q_sh, q_ss, q_sb, p.g, p.Pw)) != cudaSuccess ||
      (err = encode_map(&mo, o, hd, heads, sq, batch, o_sh, o_ss, o_sb, p.g, p.Pw)) != cudaSuccess ||
      (err = encode_map(&mk, k, hd, kv_heads, sk, batch, k_sh, k_ss, k_sb, 1, kBlockN)) != cudaSuccess ||
      (err = encode_map(&mv, v, hd, kv_heads, sk, batch, v_sh, v_ss, v_sb, 1, kBlockN)) != cudaSuccess)
    return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: err = launch_flash<32>(mq, mk, mv, mo, p, grid, s); break;
    case 64: err = launch_flash<64>(mq, mk, mv, mo, p, grid, s); break;
    case 128: err = launch_flash<128>(mq, mk, mv, mo, p, grid, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

const char* attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
