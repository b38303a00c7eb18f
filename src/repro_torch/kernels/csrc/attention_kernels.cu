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
// GQA: query head h reads KV head h / g (g = H / KV).  As in the JAX kernel
// the group is folded into the query rows: folded row r of KV head kv is
// query position r / g of head kv * g + r % g.  The kernel reads q, k, v and
// writes o through their (batch, sequence, head) strides, so nothing is
// transposed or copied in device memory.
//
// Bound.  Causal attention does 4 * B * H * hd * Sq * (Sq + 1) / 2 flops of
// bf16 products and reads Q, K, V and writes O once: at the serving shape
// (B 8, S 2048, H 24, KV 8, hd 128) 2.06e11 flops, 0.21 ms at 989 TFLOP/s,
// against 0.08 ms of bytes at 3.35 TB/s, so the tensor cores bound it.
//
// Design (simple first; WGMMA and TMA are later work).  One CTA of four warps
// owns 64 folded query rows of one (batch, KV head), 16 rows a warp, and
// walks the key tiles of 64 keys from the first up to the last one that its
// last row can see (a causal CTA skips the tiles past its diagonal; the
// heaviest CTAs are scheduled first).  Q is scaled and rounded once into
// shared memory and held in registers as mma.sync A fragments.  K and V
// stream through two shared-memory stages with cp.async (zero-filled past
// the end of the sequence), so the next tile loads while this one computes.
// Both products are mma.sync.m16n8k16 bf16 -> f32 on the tensor cores; the
// scores stay in registers, where each thread owns two query rows (a quad of
// lanes shares a row, so row max and sum take two shuffles), and become the
// PV product's A fragments without passing through memory.  V's B fragments
// come from ldmatrix.trans.  Shared rows are padded by 8 bf16 (16 bytes), so
// the fragment loads hit 32 distinct banks.  Nothing here allocates or
// synchronises with the host; the entry point launches on the caller's
// stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockM = 16 * kWarps;  // folded query rows per CTA
constexpr int kBlockN = 64;           // keys per tile
constexpr int kPad = 8;               // bf16 of padding per shared row
constexpr float kNegInf = -0.7f * 3.40282346638528859812e+38f;  // NEG_INF

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  // element strides over (batch, sequence, head); the head dim is contiguous
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int Sq, Sk, KV, g;
  float scale;
  int causal;
};

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// c += a (16x16, row major) * b (16x8, column major); bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

template <int HD>
constexpr int smem_bytes() {
  return (kBlockM + 4 * kBlockN) * (HD + kPad) * 2;  // Q, two stages of K and V
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr int LD = HD + kPad;     // shared row stride, in bf16
  constexpr int kChunks = HD / 8;   // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + kBlockM * LD;
  __nv_bfloat16* sV = sK + 2 * kBlockN * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment row / column pair
  const int rows = p.Sq * p.g;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;  // heaviest first
  const int b = blockIdx.y / p.KV, kvh = blockIdx.y % p.KV;
  const __nv_bfloat16* qb = p.q + b * p.q_sb + static_cast<long long>(kvh) * p.g * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + kvh * p.v_sh;
  __nv_bfloat16* ob = p.o + b * p.o_sb + static_cast<long long>(kvh) * p.g * p.o_sh;

  int n_tiles = (p.Sk + kBlockN - 1) / kBlockN;
  if (p.causal) {
    const int last_pos = (min(r0 + kBlockM, rows) - 1) / p.g;
    n_tiles = min(n_tiles, last_pos / kBlockN + 1);
  }

  auto load_kv = [&](int t, int stage) {
    __nv_bfloat16* dk = sK + stage * kBlockN * LD;
    __nv_bfloat16* dv = sV + stage * kBlockN * LD;
    for (int c = tid; c < kBlockN * kChunks; c += kThreads) {
      const int row = c / kChunks, col = (c % kChunks) * 8;
      const int n = t * kBlockN + row;
      const bool ok = n < p.Sk;
      const long long nn = ok ? n : 0;
      cp_async16(dk + row * LD + col, kb + nn * p.k_ss + col, ok);
      cp_async16(dv + row * LD + col, vb + nn * p.v_ss + col, ok);
    }
    cp_async_commit();
  };
  load_kv(0, 0);

  // Q: scaled in f32 and rounded to bf16 once; rows past the end are zero
  for (int c = tid; c < kBlockM * kChunks; c += kThreads) {
    const int row = c / kChunks, col = (c % kChunks) * 8;
    const int r = r0 + row;
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      const long long i = r / p.g, j = r % p.g;
      const uint4 raw = *reinterpret_cast<const uint4*>(qb + i * p.q_ss + j * p.q_sh + col);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
      __nv_bfloat16* f = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
      for (int x = 0; x < 8; ++x) f[x] = __float2bfloat16_rn(__bfloat162float(e[x]) * p.scale);
    }
    *reinterpret_cast<uint4*>(sQ + row * LD + col) = packed;
  }
  __syncthreads();

  const int wr = warp * 16;
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const __nv_bfloat16* qa = sQ + (wr + gid) * LD + kk * 16 + tig * 2;
    qf[kk][0] = lds32(qa);
    qf[kk][1] = lds32(qa + 8 * LD);
    qf[kk][2] = lds32(qa + 8);
    qf[kk][3] = lds32(qa + 8 * LD + 8);
  }
  const int ra = r0 + wr + gid, rb = ra + 8;  // this thread's two rows
  const int pos_a = ra / p.g, pos_b = rb / p.g;

  float acc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_kv(t + 1, (t + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* cK = sK + (t & 1) * kBlockN * LD;
    const __nv_bfloat16* cV = sV + (t & 1) * kBlockN * LD;

    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        const __nv_bfloat16* kr = cK + (nt * 8 + gid) * LD + kk * 16 + tig * 2;
        mma_bf16(s[nt], qf[kk], lds32(kr), lds32(kr + 8));
      }
    }

    const int n0 = t * kBlockN;
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + nt * 8 + tig * 2 + (e & 1);
        const int pos = e < 2 ? pos_a : pos_b;
        if (key >= p.Sk || (p.causal && key > pos)) s[nt][e] = kNegInf;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[nt][0], s[nt][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[nt][2], s[nt][3]));
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float corr_a = __expf(m_a - mx_a), corr_b = __expf(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;

    // p = exp(s - m): f32 into the row sums, bf16 into the PV A fragments
    uint32_t pf[kBlockN / 16][4];
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      const float p0 = __expf(s[nt][0] - m_a), p1 = __expf(s[nt][1] - m_a);
      const float p2 = __expf(s[nt][2] - m_b), p3 = __expf(s[nt][3] - m_b);
      sum_a += p0 + p1;
      sum_b += p2 + p3;
      pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      acc[d][0] *= corr_a;
      acc[d][1] *= corr_a;
      acc[d][2] *= corr_b;
      acc[d][3] *= corr_b;
    }

    // acc += P (16 x 64) . V (64 x HD); V's B fragments by ldmatrix.trans:
    // matrices (keys +0..7, dims d), (+8..15, d), (+0..7, d + 8), (+8..15, d + 8)
    const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
    for (int kt = 0; kt < kBlockN / 16; ++kt) {
#pragma unroll
      for (int d = 0; d < HD / 8; d += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, cV + (kt * 16 + (mi & 1) * 8 + mr) * LD + (d + (mi >> 1)) * 8);
        mma_bf16(acc[d], pf[kt], vf[0], vf[1]);
        mma_bf16(acc[d + 1], pf[kt], vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is reloaded by the next iteration's copy
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  __nv_bfloat16* oa = ob + static_cast<long long>(ra / p.g) * p.o_ss
                      + static_cast<long long>(ra % p.g) * p.o_sh + tig * 2;
  __nv_bfloat16* oc = ob + static_cast<long long>(rb / p.g) * p.o_ss
                      + static_cast<long long>(rb % p.g) * p.o_sh + tig * 2;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    if (ra < rows)
      *reinterpret_cast<uint32_t*>(oa + d * 8) = pack_bf16(acc[d][0] / den_a, acc[d][1] / den_a);
    if (rb < rows)
      *reinterpret_cast<uint32_t*>(oc + d * 8) = pack_bf16(acc[d][2] / den_b, acc[d][3] / den_b);
  }
}

template <int HD>
cudaError_t launch_flash(const Params& p, int batch, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq * p.g + kBlockM - 1) / kBlockM, batch * p.KV);
  flash_fwd_kernel<HD><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// o (B, Sq, H, hd) = attention of q (B, Sq, H, hd) over k, v (B, Sk, KV, hd),
// all bf16 with the head dim contiguous; strides in elements.  hd is 32, 64
// or 128.  causal != 0 masks key > query position.
int attention_flash_fwd(int device, const void* q, const void* k, const void* v, void* o,
                        long long batch, long long sq, long long sk, long long heads,
                        long long kv_heads, long long hd,
                        long long q_sb, long long q_ss, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        long long o_sb, long long o_ss, long long o_sh,
                        float scale, int causal, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || sq <= 0 || sk <= 0 || kv_heads <= 0 || heads % kv_heads
      || batch * kv_heads > 65535 || sq * (heads / kv_heads) > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.Sq = static_cast<int>(sq);
  p.Sk = static_cast<int>(sk);
  p.KV = static_cast<int>(kv_heads);
  p.g = static_cast<int>(heads / kv_heads);
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: err = launch_flash<32>(p, static_cast<int>(batch), s); break;
    case 64: err = launch_flash<64>(p, static_cast<int>(batch), s); break;
    case 128: err = launch_flash<128>(p, static_cast<int>(batch), s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

const char* attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
