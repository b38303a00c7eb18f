"""What the design choices of four CUDA kernels are worth, measured on the card.

Not a pytest module (it needs a CUDA card and ``nvcc``): run it by hand on
the GPU machine from the root of a checkout,

    PYTHONPATH=src python tests/torch_kernel_ablation_check.py [--only flash,xor,loops,segment]

It builds variants of the committed sources by text substitution (into
``build/ablation/``; a substitution whose text is no longer in the source
fails loudly) and times each at the main path's shape, in turns with the
committed kernel and the library call in one process:

* ``attention_kernels.cu`` at the serving shape (B 8, S 2048, H 24, KV 8,
  hd 128, causal): as committed; with FlashAttention-3's ping-pong (two
  named barriers make the consumer warpgroups take turns on the tensor
  cores); without the overlap of the softmax with the PV product (the
  consumer waits for both products before its softmax); beside
  ``scaled_dot_product_attention``.  Each variant is held against the plain
  version (max abs error).  A last variant counts clock64 cycles of each
  consumer stage (waits for Q, K/V and the products, the Q scaling, the
  softmax, the last PV product, the epilogue), summed over its work.
* ``block_kernels.cu``'s XOR delta at 32,768 blocks: as committed (a fixed
  chunk of four int4 pairs a thread, plain loads and stores); the same with
  streaming hints (``ld/st.global.cs``); a grid-stride loop over a grid
  sized to the card (SMs x resident CTAs) with the hints; beside
  ``torch.bitwise_xor``.  Each variant must be bit-identical.
* ``segment_kernels.cu``'s Prim and Modified-Prim loops on the solver
  phase's graphs at n = 66,000 (``chip_smoke.solver_graph``): the committed
  kernels at chunks of 128, 256 (the default) and 512 keys, each
  bit-identical to the default; then a variant that counts the clock64
  cycles of each stage of a step (the selection, the relaxation, the chain
  walk with its second pass, the recomputation of the dirty chunks) in the
  block's first thread, and the steps that walked a chain.

* ``segment_kernels.cu``'s reductions at the main path's shapes (the
  131,072 x 32 in-edge matrix of ``chip_smoke.padded_rows_like``, the LMG
  candidate vector of 2**20 and the 131,072-key vector of ``chip_smoke``'s
  phase e): the earlier design (``tests/torch_segment_earlier.cu``: a warp a
  row, two launches for 1d) beside the committed one and its variants:
  4-byte loads for the rows; 1, 2, 4 and 8 rows (loads) in flight a thread
  for both row bodies (committed: 4 for the min, 2 for the argmin); the row
  grid capped at 1, 2 and 4 blocks an SM (committed: the blocks an SM
  holds); for 1d (committed: blocks of 256, chunks of 4 loads, the grid of
  whole chunks but at least one block an SM while every thread has a
  vector), chunks of 2 and 8, blocks of 512, one block an SM, the grid of
  whole chunks alone, the ticket as two fences and a relaxed atomic in
  place of one acquire-release atomic, the last block's finish in one
  warp, and clusters of 8 blocks that gather their parts through
  distributed shared memory before one ticket a cluster.
  Each is held against the plain version (the earlier design by value: its
  min may differ in the sign of a zero); beside ``torch.amin``,
  ``torch.argmin``, ``torch.min`` and an empty kernel (the launch floor).

The last line is one JSON object with every time, and the card's name and
power limit.
"""

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import cuda_ms  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402

OUT = ROOT / "build" / "ablation"

PING_PONG = [
    ("    uint32_t it = 0;  // key tiles consumed so far (the rings' position)\n",
     "    uint32_t it = 0;  // key tiles consumed so far (the rings' position)\n"
     "    if (c == 1) bar_arrive(1, 256);\n"),
    ("        issue_s(s);\n        if (stored",
     "        bar_sync(1 + c, 256);\n        issue_s(s);\n        bar_arrive(2 - c, 256);\n"
     "        if (stored"),
    ("        issue_s(s);\n        issue_pv(sp);\n",
     "        bar_sync(1 + c, 256);\n        issue_s(s);\n        issue_pv(sp);\n"
     "        bar_arrive(2 - c, 256);\n"),
    ("        fence_regs(o);\n        issue_pv(sp);\n        wgmma_wait<0>();",
     "        fence_regs(o);\n        bar_sync(1 + c, 256);\n        issue_pv(sp);\n"
     "        bar_arrive(2 - c, 256);\n        wgmma_wait<0>();"),
    ("      stored = buf;\n    }\n",
     "      stored = buf;\n    }\n    if (c == 0) bar_sync(1, 256);  // consumer 1's last arrival\n"),
    ("__device__ __forceinline__ void bar_sync(int id, int threads) {",
     "__device__ __forceinline__ void bar_arrive(int id, int threads) {\n"
     "  asm volatile(\"bar.arrive %0, %1;\" :: \"r\"(id), \"r\"(threads) : \"memory\");\n}\n\n"
     "__device__ __forceinline__ void bar_sync(int id, int threads) {"),
]
NO_OVERLAP = [("        wgmma_wait<1>();\n", "        wgmma_wait<0>();\n")]
FLASH = {"committed": [], "ping-pong": PING_PONG, "no softmax/PV overlap": NO_OVERLAP}

# clock64 cycle counts of a consumer's stages, summed over its work, per CTA
STAGES = ("Q wait", "Q scale", "K/V wait", "S wait", "softmax", "PV wait", "key tile 0",
          "last PV", "epilogue", "key tiles", "total")
CYCLES = [
    ("namespace {\n", "namespace {\n__device__ long long g_cycles[1024][2][11];\n"),
    ("    uint32_t it = 0;  // key tiles consumed so far (the rings' position)\n",
     "    uint32_t it = 0;  // key tiles consumed so far (the rings' position)\n"
     "    long long cy[11] = {0}, _a, _b;\n    const long long t_start = clock64();\n"),
    ("      mbar_wait(q_full + 8 * buf, (k >> 1) & 1);\n      const int w = tile_of[buf];\n",
     "      _a = clock64();\n      mbar_wait(q_full + 8 * buf, (k >> 1) & 1);\n"
     "      cy[0] += clock64() - _a;\n      const int w = tile_of[buf];\n"),
    ("      const uint32_t sQb = sQ + buf * G::kQBytes;\n",
     "      const uint32_t sQb = sQ + buf * G::kQBytes;\n      _a = clock64();\n"),
    ("      const uint64_t dq = make_desc(", "      cy[1] += clock64() - _a;\n      const uint64_t dq = make_desc("),
    ("        mbar_wait(full_k + 8 * s, (it / kStages) & 1);\n        mbar_wait(full_v",
     "        _a = clock64();\n        ++cy[9];\n        mbar_wait(full_k + 8 * s, (it / kStages) & 1);\n"
     "        mbar_wait(full_v"),
    ("        fence_regs(o);\n        issue_s(s);\n        issue_pv(sp);\n",
     "        cy[2] += clock64() - _a;\n        fence_regs(o);\n        issue_s(s);\n        issue_pv(sp);\n"),
    ("        wgmma_wait<1>();\n", "        _a = clock64();\n        wgmma_wait<1>();\n        cy[3] += clock64() - _a;\n"),
    ("        softmax(t);\n", "        _a = clock64();\n        softmax(t);\n        cy[4] += clock64() - _a;\n"),
    ("        wgmma_wait<0>();\n        fence_regs(o);\n        if (lane == 0) mbar_arrive(empty_v + 8 * sp);\n#pragma unroll",
     "        _a = clock64();\n        wgmma_wait<0>();\n        cy[5] += clock64() - _a;\n        fence_regs(o);\n"
     "        if (lane == 0) mbar_arrive(empty_v + 8 * sp);\n#pragma unroll"),
    ("      {  // key tile 0: S alone\n", "      _b = clock64();\n      ++cy[9];\n      {  // key tile 0: S alone\n"),
    ("        ++it;\n      }\n", "        ++it;\n      }\n      cy[6] += clock64() - _b;\n"),
    ("      {  // O += P V of the last tile\n", "      _b = clock64();\n      {  // O += P V of the last tile\n"),
    ("      // out = acc / max(l, 1e-30), staged", "      cy[7] += clock64() - _b;\n      _b = clock64();\n"
     "      // out = acc / max(l, 1e-30), staged"),
    ("      stored = buf;\n", "      stored = buf;\n      cy[8] += clock64() - _b;\n"),
    ("    if (t128 == 0) asm volatile(\"cp.async.bulk.wait_group 0;\"",
     "    cy[10] = clock64() - t_start;\n"
     "    if (t128 == 0 && blockIdx.x < 1024)\n"
     "      for (int i = 0; i < 11; ++i) g_cycles[blockIdx.x][c][i] = cy[i];\n"
     "    if (t128 == 0) asm volatile(\"cp.async.bulk.wait_group 0;\""),
    ('}  // extern "C"', 'int read_cycles(void* host) {\n'
     '  return static_cast<int>(cudaMemcpyFromSymbol(host, g_cycles, sizeof(g_cycles)));\n}\n\n'
     '}  // extern "C"'),
]

XOR_CS = [("      x[u] = a[i];\n      y[u] = b[i];\n", "      x[u] = __ldcs(a + i);\n      y[u] = __ldcs(b + i);\n"),
          ("      out[i] = make_int4(", "      __stcs(out + i, make_int4("),
          ("                         x[u].w ^ y[u].w);\n", "                         x[u].w ^ y[u].w));\n")]
GRID_STRIDE_KERNEL = """__global__ void __launch_bounds__(kThreads)
xor_delta_kernel(const int4* __restrict__ a, const int4* __restrict__ b,
                 int4* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (; i + (kXorWords - 1) * stride < n; i += kXorWords * stride) {
    int4 x[kXorWords], y[kXorWords];
#pragma unroll
    for (int u = 0; u < kXorWords; ++u) {
      x[u] = __ldcs(a + i + u * stride);
      y[u] = __ldcs(b + i + u * stride);
    }
#pragma unroll
    for (int u = 0; u < kXorWords; ++u)
      __stcs(out + i + u * stride, make_int4(x[u].x ^ y[u].x, x[u].y ^ y[u].y,
                                             x[u].z ^ y[u].z, x[u].w ^ y[u].w));
  }
  for (; i < n; i += stride) {
    const int4 x = __ldcs(a + i), y = __ldcs(b + i);
    __stcs(out + i, make_int4(x.x ^ y.x, x.y ^ y.y, x.z ^ y.z, x.w ^ y.w));
  }
}

"""
GRID_STRIDE_LAUNCH = """    long long grid = (n16 + kThreads - 1) / kThreads;
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, xor_delta_kernel, kThreads, 0);
    if (grid > static_cast<long long>(sms) * per_sm) grid = static_cast<long long>(sms) * per_sm;
"""


def variant(stem: str, name: str, subs) -> Path:
    """Write ``csrc/<stem>.cu`` with ``subs`` applied; return the .cu path."""
    src = (kernels.CSRC / f"{stem}.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"{stem} / {name}: the text to replace is gone: {old[:60]!r}")
        src = src.replace(old, new, 1)
    path = OUT / (stem + "_" + "".join(ch if ch.isalnum() else "_" for ch in name) + ".cu")
    path.write_text(src)
    return path


def xor_grid_stride_subs():
    src = (kernels.CSRC / "block_kernels.cu").read_text()
    start = src.index("__global__ void __launch_bounds__(kThreads)\nxor_delta_kernel")
    end = src.index("__global__ void block_hash_kernel")
    launch_start = src.index("    const long long grid = (n16 + kThreads * kXorWords - 1)")
    launch_end = src.index("    xor_delta_kernel<<<")
    return [(src[start:end], GRID_STRIDE_KERNEL), (src[launch_start:launch_end], GRID_STRIDE_LAUNCH)]


def build(jobs: dict) -> dict:
    """name -> .so, every nvcc at once, with the source's committed flags."""
    procs = {}
    for name, (stem, cu) in jobs.items():
        so = cu.with_suffix(".so")
        cmd = [kernels._nvcc(), *kernels.compile_flags(stem), "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{out[-3000:]}")
        serial = [line.strip() for line in out.splitlines() if "C7514" in line]
        if serial:
            print(f"{name}: ptxas: {serial[0][:160]}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


# clock64 cycles of each stage of a loop step, thread 0 of the block, per
# kernel (0 Prim, 1 MP): the stages end at the step's block barriers
LOOP_STAGES = ("selection", "relaxation", "chain walk", "chunk recompute", "steps",
               "total", "chain walks")
LOOP_CYCLES = [
    ("namespace {\n", "namespace {\n__device__ long long g_loop_cycles[2][7];\n"),
    # Prim
    ("  init_chunks(s, in_tree, best, nchunks, chunk, nvp);\n  __syncthreads();\n",
     "  init_chunks(s, in_tree, best, nchunks, chunk, nvp);\n  __syncthreads();\n"
     "  long long cy[7] = {0}, _t;\n  const long long _t0 = clock64();\n"),
    ("    select_min(s, nchunks, bmin, u);\n",
     "    _t = clock64();\n    select_min(s, nchunks, bmin, u);\n"
     "    cy[0] += clock64() - _t;\n    _t = clock64();\n"),
    ("    __syncthreads();\n    recompute_dirty(s, in_tree, best, chunk, nvp);\n    __syncthreads();\n",
     "    __syncthreads();\n    cy[1] += clock64() - _t;\n    _t = clock64();\n"
     "    recompute_dirty(s, in_tree, best, chunk, nvp);\n    __syncthreads();\n"
     "    cy[3] += clock64() - _t;\n    ++cy[4];\n"),
    ("    if (threadIdx.x == 0) s.ndirty = 0;  // next listed after next selection\n  }\n}\n",
     "    if (threadIdx.x == 0) s.ndirty = 0;  // next listed after next selection\n  }\n"
     "  cy[5] = clock64() - _t0;\n"
     "  if (threadIdx.x == 0) for (int i = 0; i < 7; ++i) g_loop_cycles[0][i] = cy[i];\n}\n"),
    # MP
    ("  init_chunks(s, in_tree, l, nchunks, chunk, nvp);\n  __syncthreads();\n",
     "  init_chunks(s, in_tree, l, nchunks, chunk, nvp);\n  __syncthreads();\n"
     "  long long cy[7] = {0}, _t;\n  const long long _t0 = clock64();\n"),
    ("    select_min(s, nchunks, li, vi);\n",
     "    _t = clock64();\n    select_min(s, nchunks, li, vi);\n"
     "    cy[0] += clock64() - _t;\n    _t = clock64();\n"),
    ("    if (__syncthreads_or(cand)) {\n",
     "    const int _any = __syncthreads_or(cand);\n    cy[1] += clock64() - _t;\n"
     "    _t = clock64();\n    if (_any) {\n      ++cy[6];\n"),
    ("    recompute_dirty(s, in_tree, l, chunk, nvp);\n    __syncthreads();\n"
     "    if (threadIdx.x == 0) s.ndirty = 0;\n  }\n}\n",
     "    cy[2] += clock64() - _t;\n    _t = clock64();\n"
     "    recompute_dirty(s, in_tree, l, chunk, nvp);\n    __syncthreads();\n"
     "    cy[3] += clock64() - _t;\n    ++cy[4];\n"
     "    if (threadIdx.x == 0) s.ndirty = 0;\n  }\n  cy[5] = clock64() - _t0;\n"
     "  if (threadIdx.x == 0) for (int i = 0; i < 7; ++i) g_loop_cycles[1][i] = cy[i];\n}\n"),
    ('}  // extern "C"', 'int read_loop_cycles(void* host) {\n'
     '  return static_cast<int>(cudaMemcpyFromSymbol(host, g_loop_cycles, sizeof(g_loop_cycles)));\n'
     '}\n\n}  // extern "C"'),
]
LOOP_CHUNKS = (128, 256, 512)


def loop_ablation(lib, cycles_lib, dev, times: dict) -> None:
    """The loops at each chunk size, then their cycles by stage."""
    import numpy as np

    from chip_smoke import SOLVER_N, solver_graph
    from repro_torch.core import OptimizeSpec, optimize
    from repro_torch.core.solvers import torch_backend as tb

    gu, gd = solver_graph(SOLVER_N, False), solver_graph(SOLVER_N, True)
    theta = optimize(gd, OptimizeSpec.problem(2, backend="numpy")).solution.max_recreation() * 1.5
    stream = torch.cuda.current_stream().cuda_stream
    entries = kernels._ENTRIES["segment_kernels"][1]
    for which in (lib, cycles_lib):
        for entry in ("segment_prim_loop", "segment_mp_loop"):
            fn = getattr(which, entry)
            fn.argtypes, fn.restype = entries[entry], ctypes.c_int
    prim = tb.prim_state(gu.arrays(), dev)
    mp = tb.mp_state(gd.arrays(), theta, dev)
    nvp, width = prim[0].shape
    mark = torch.zeros(mp[0].shape[0] + 2, dtype=torch.int32, device=dev)
    loops = {
        "prim": (prim[2:], lambda which, st, c: which.segment_prim_loop(
            0, prim[0].data_ptr(), prim[1].data_ptr(), *(t.data_ptr() for t in st),
            nvp, width, SOLVER_N, c, stream)),
        "mp": (mp[4:], lambda which, st, c: which.segment_mp_loop(
            0, *(t.data_ptr() for t in mp[:4]), *(t.data_ptr() for t in st),
            mark.zero_().data_ptr(), nvp, mp[0].shape[1], SOLVER_N, c, stream)),
    }
    for name, (init, call) in loops.items():
        work = [t.clone() for t in init]

        def run(which, c):
            for w, t in zip(work, init):
                w.copy_(t)
            assert call(which, work, c) == 0

        run(lib, 256)
        torch.cuda.synchronize()
        want = [t.clone() for t in work]
        for rep in range(2):
            for c in LOOP_CHUNKS:
                ms = cuda_ms(lambda: run(lib, c), iters=3, warmup=1)
                if not all(torch.equal(a, b) for a, b in zip(work, want)):
                    raise SystemExit(f"{name} loop at chunk {c}: differs from chunk 256")
                times.setdefault(f"{name} loop chunk {c}", []).append(ms)
            print(f"{name} loop, n = {SOLVER_N}: " + "  ".join(
                f"chunk {c} {times[f'{name} loop chunk {c}'][-1]:.3f} ms" for c in LOOP_CHUNKS),
                flush=True)
        run(cycles_lib, 256)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(work, want)):
            raise SystemExit(f"{name} loop, cycle-counting variant: differs")
    cyc = np.zeros((2, len(LOOP_STAGES)), dtype=np.int64)
    cycles_lib.read_loop_cycles.argtypes = [ctypes.c_void_p]
    cycles_lib.read_loop_cycles.restype = ctypes.c_int
    assert cycles_lib.read_loop_cycles(cyc.ctypes.data) == 0
    for k, name in enumerate(loops):
        c = {n: int(x) for n, x in zip(LOOP_STAGES, cyc[k])}
        steps = max(c["steps"], 1)
        print(f"{name} loop cycles (thread 0, chunk 256): " + ", ".join(
            f"{n} {c[n]} ({c[n] / c['total']:.3f}, {c[n] / steps:.0f} a step)"
            for n in LOOP_STAGES[:4]) + f"; {c['steps']} steps, {c['total']} cycles, "
            f"{c['chain walks']} chain walks", flush=True)
        times[f"{name} loop cycles"] = c


SEG_EARLIER = Path(__file__).resolve().with_name("torch_segment_earlier.cu")
# clusters of 8 blocks for 1d: each cluster's rank 0 gathers its blocks' bests
# from their shared memory, and one ticket a cluster picks the last
SEG_CLUSTER_KERNEL = """constexpr int kCluster = 8;

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads1d)
argmin_1d_cluster_kernel(const float* __restrict__ x, long long n, int head,
                         unsigned int* ticket, Best* parts,
                         float* __restrict__ out_val, int32_t* __restrict__ out_idx) {
  namespace cg = cooperative_groups;
  __shared__ Best mine;
  __shared__ bool last;
  const Best b = block_best(share_best(x, n, head));
  if (threadIdx.x == 0) mine = b;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const unsigned rank = cluster.block_rank();
  if (rank == 0 && threadIdx.x < kWarp) {
    Best o = threadIdx.x < kCluster ? *cluster.map_shared_rank(&mine, threadIdx.x)
                                    : no_best();
    for (int off = kCluster / 2; off > 0; off >>= 1) merge_lanes(o, off);
    if (threadIdx.x == 0) {
      const unsigned c = blockIdx.x / kCluster, nc = gridDim.x / kCluster;
      parts[c] = o;
      __threadfence();
      last = atomicInc(ticket, nc - 1) == nc - 1;
    }
  }
  cluster.sync();  // every block's `mine` stays until rank 0 has read it
  if (rank != 0 || !last) return;
  const Best p = parts_best(parts, gridDim.x / kCluster);
  if (threadIdx.x == 0) write_best(p, n, out_val, out_idx);
}

"""
SEG_CLUSTER_ENTRY = """int segment_min_argmin_1d_cluster(int device, const void* x, void* out_val,
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
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long whole = (nv + kThreads1d * kUnroll1d - 1) / (kThreads1d * kUnroll1d);
  const long long spread = (nv + kThreads1d - 1) / kThreads1d;
  long long grid = whole > sms ? whole : sms;  // the committed kernel's rule
  if (grid > spread) grid = spread;
  if (grid > 8LL * sms) grid = 8LL * sms;
  grid = (grid + kCluster - 1) / kCluster * kCluster;
  if (grid < kCluster) grid = kCluster;
  if (grid / kCluster > max_parts) return static_cast<int>(cudaErrorInvalidValue);
  char* ws = static_cast<char*>(workspace);
  argmin_1d_cluster_kernel<<<static_cast<unsigned>(grid), kThreads1d, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, static_cast<int>(head),
      reinterpret_cast<unsigned int*>(ws), reinterpret_cast<Best*>(ws + kPartsOffset),
      static_cast<float*>(out_val), static_cast<int32_t*>(out_idx));
  return static_cast<int>(cudaGetLastError());
}

"""
SEG_CLUSTER = [
    ("#include <atomic>\n", "#include <atomic>\n\n#include <cooperative_groups.h>\n"),
    ("__global__ void empty_kernel() {}\n", SEG_CLUSTER_KERNEL + "__global__ void empty_kernel() {}\n"),
    ("// One empty kernel: the floor under any launch of this library.\n",
     SEG_CLUSTER_ENTRY + "// One empty kernel: the floor under any launch of this library.\n"),
]


def seg_rows_unroll(u: int) -> list:
    """Both row bodies with ``u`` rows (loads) in flight a thread."""
    return [("  static constexpr int kUnroll = 4;  // rows a thread loads before it reduces",
             f"  static constexpr int kUnroll = {u};"),
            ("  static constexpr int kUnroll = 2;  // its compare costs more: fewer rows",
             f"  static constexpr int kUnroll = {u};")]


def seg_1d(threads: int = 256, u: int = 4) -> list:
    """The 1d reduction with blocks of ``threads`` and chunks of ``u`` loads."""
    return [("constexpr int kThreads1d = 256;", f"constexpr int kThreads1d = {threads};"),
            ("constexpr int kUnroll1d = 4;", f"constexpr int kUnroll1d = {u};")]


SEG_1D_CAP = "  const long long target = std::max(whole, sms);\n"


def seg_rows_grid(per_sm: int) -> list:
    return [("    if (grid > card) grid = card;\n",
             f"    if (grid > {per_sm} * sms) grid = {per_sm} * sms;\n")]


# the ticket as a fence, a relaxed atomicInc, and a fence in the last block
SEG_FENCE_TICKET = [
    ("  unsigned int old;\n  asm volatile(\"atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;\"\n"
     "               : \"=r\"(old)\n               : \"l\"(ticket), \"r\"(count - 1)\n"
     "               : \"memory\");\n  return old == count - 1;\n",
     "  __threadfence();\n  return atomicInc(ticket, count - 1) == count - 1;\n"),
    ("Best parts_best(const Best* parts, unsigned count) {\n",
     "Best parts_best(const Best* parts, unsigned count) {\n  __threadfence();\n"),
]
# the last block's finish in its first warp alone: no barrier
SEG_WARP_FINISH = [
    ("  Best p = no_best();\n  for (unsigned j = threadIdx.x; j < count; j += kThreads1d) {\n",
     "  Best p = no_best();\n  if (threadIdx.x >= kWarp) return p;\n"
     "  for (unsigned j = threadIdx.x; j < count; j += kWarp) {\n"),
    ("    merge(p, o);\n  }\n  return block_best(p);\n",
     "    merge(p, o);\n  }\n"
     "  for (int off = kWarp / 2; off > 0; off >>= 1) merge_lanes(p, off);\n  return p;\n"),
]

# variant -> (substitutions, what it is timed on)
SEG_VARIANTS = {
    "committed": ([], ("rows", "1d")),
    "4-byte loads": ([("    const int vec = width % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;\n",
                       "    const int vec = 0;\n")], ("rows",)),
    **{f"rows, {u} a thread": (seg_rows_unroll(u), ("rows",)) for u in (1, 2, 4, 8)},
    **{f"rows, grid {k} a SM": (seg_rows_grid(k), ("rows",)) for k in (1, 2, 4)},
    "1d, chunks of 2": (seg_1d(u=2), ("1d",)),
    "1d, chunks of 8": (seg_1d(u=8), ("1d",)),
    "1d, 512 threads": (seg_1d(threads=512), ("1d",)),
    "1d, one block a SM": ([(SEG_1D_CAP, "  const long long target = sms;\n")], ("1d",)),
    "1d, whole chunks": ([(SEG_1D_CAP, "  const long long target = whole;\n")], ("1d",)),
    "1d, fence ticket": (SEG_FENCE_TICKET, ("1d",)),
    "1d, one-warp finish": (SEG_WARP_FINISH, ("1d",)),
    "1d, clusters of 8": (SEG_CLUSTER, ("1d",)),
}


def segment_ablation(libs: dict, dev, times: dict) -> None:
    """The row and 1d reductions: the earlier design, the committed one and
    its variants, in turns, each held against the plain version."""
    from chip_smoke import LMG_CANDIDATES, padded_rows_like
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_ops import WORKSPACE_BYTES

    g = torch.Generator(device=dev).manual_seed(1505_05211 + 1)
    rows, width = 131_072, 32
    x = padded_rows_like(g, rows, width, dev)
    cand = torch.ones(LMG_CANDIDATES, device=dev)
    scored = torch.randint(0, LMG_CANDIDATES, (4096,), device=dev, generator=g)
    cand[scored] = -torch.rand(4096, device=dev, generator=g) * 10
    key = torch.rand(rows, device=dev, generator=g) * 1e6
    key[torch.rand(rows, device=dev, generator=g) < 0.6] = torch.inf
    vectors = {"1d 2**20": cand, "1d 131,072": key}
    want = {"rows min": ref.segment_min_rows_ref(x), "rows argmin": ref.segment_argmin_rows_ref(x)}
    want.update({k: ref.min_argmin_1d_ref(v) for k, v in vectors.items()})
    out_f = torch.empty(rows, device=dev)
    out_i = torch.empty(rows, dtype=torch.int32, device=dev)
    val = torch.empty((), device=dev)
    idx = torch.empty((), dtype=torch.int32, device=dev)
    part_val = torch.empty(256, device=dev)
    part_idx = torch.empty(256, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    _i, _ll, _vp = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    entries = kernels._ENTRIES["segment_kernels"][1]

    def bind(lib, name, argtypes):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn

    def ok(err):
        assert err == 0, err

    calls = {}  # (variant, measure) -> call
    for name, (_, measures) in {"earlier design": (None, ("rows", "1d")), **SEG_VARIANTS}.items():
        lib = libs[f"segment {name}"]
        mn = bind(lib, "segment_min_rows", entries["segment_min_rows"])
        am = bind(lib, "segment_argmin_rows", entries["segment_argmin_rows"])
        if "rows" in measures:
            calls[name, "rows min"] = lambda mn=mn: ok(mn(0, x.data_ptr(), out_f.data_ptr(),
                                                          rows, width, stream))
            calls[name, "rows argmin"] = lambda am=am: ok(am(0, x.data_ptr(), out_i.data_ptr(),
                                                             rows, width, stream))
        if "1d" not in measures:
            continue
        if name == "earlier design":
            fn = bind(lib, "segment_min_argmin_1d", [_i] + [_vp] * 5 + [_ll] * 2 + [_vp])
            for what, v in vectors.items():
                parts = min(256, -(-v.numel() // 2048))
                calls[name, what] = lambda fn=fn, v=v, parts=parts: ok(fn(
                    0, v.data_ptr(), part_val.data_ptr(), part_idx.data_ptr(), val.data_ptr(),
                    idx.data_ptr(), v.numel(), parts, stream))
            continue
        entry = ("segment_min_argmin_1d_cluster" if name == "1d, clusters of 8"
                 else "segment_min_argmin_1d")
        fn = bind(lib, entry, entries["segment_min_argmin_1d"])
        ws = torch.zeros(WORKSPACE_BYTES, dtype=torch.uint8, device=dev)
        for what, v in vectors.items():
            calls[name, what] = lambda fn=fn, v=v, ws=ws: ok(fn(
                0, v.data_ptr(), val.data_ptr(), idx.data_ptr(), ws.data_ptr(), v.numel(),
                ws.numel(), stream))

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    for (name, what), call in calls.items():  # each must agree before it is timed
        call()
        torch.cuda.synchronize()
        if what == "rows min":
            got, ref_v = (out_f,), (want[what],)
        elif what == "rows argmin":
            got, ref_v = (out_i,), (want[what],)
        else:
            got, ref_v = (val, idx), want[what]
        same = all(torch.equal(a, b) if name == "earlier design" else torch.equal(bits(a), bits(b))
                   for a, b in zip(got, ref_v))
        if not same:
            raise SystemExit(f"segment {name}, {what}: differs from the plain version")
    floor = bind(libs["segment committed"], "segment_launch_floor", entries["segment_launch_floor"])
    library = {"rows min": lambda: torch.amin(x, 1), "rows argmin": lambda: torch.argmin(x, 1),
               "1d 2**20": lambda: torch.min(cand, 0), "1d 131,072": lambda: torch.min(key, 0)}
    for rep in range(3):
        for (name, what), call in calls.items():
            times.setdefault(f"{what}: {name}", []).append(cuda_ms(call))
        for what, call in library.items():
            times.setdefault(f"{what}: torch", []).append(cuda_ms(call))
        times.setdefault("launch floor (an empty kernel)", []).append(
            cuda_ms(lambda: ok(floor(0, stream))))
        for what in ("rows min", "rows argmin", "1d 2**20", "1d 131,072"):
            print(f"segment {what}, rep {rep}: " + "  ".join(
                f"{k.split(': ', 1)[1]} {t[-1] * 1e3:.3f} us" for k, t in times.items()
                if k.startswith(what + ": ")), flush=True)
        print(f"launch floor {times['launch floor (an empty kernel)'][-1] * 1e3:.3f} us", flush=True)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="flash,xor,loops,segment",
                    help="comma-separated subset of flash, xor, loops, segment")
    only = set(ap.parse_args(argv).only.split(","))
    if not torch.cuda.is_available():
        print("torch_kernel_ablation_check: no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    if "flash" in only:
        jobs = {f"flash {n}": ("attention_kernels", variant("attention_kernels", n, subs))
                for n, subs in FLASH.items()}
        jobs["flash cycles"] = ("attention_kernels",
                                variant("attention_kernels", "cycles", CYCLES))
    xor = {"committed": [], "streaming hints": XOR_CS,
           "card-sized grid-stride, hints": xor_grid_stride_subs()}
    if "xor" in only:
        jobs.update({f"xor {n}": ("block_kernels", variant("block_kernels", n, subs))
                     for n, subs in xor.items()})
    if "loops" in only:
        jobs["loops"] = ("segment_kernels", variant("segment_kernels", "committed", []))
        jobs["loop cycles"] = ("segment_kernels",
                               variant("segment_kernels", "cycles", LOOP_CYCLES))
    if "segment" in only:
        earlier = OUT / "segment_kernels_earlier_design.cu"
        earlier.write_text(SEG_EARLIER.read_text())
        jobs["segment earlier design"] = ("segment_kernels", earlier)
        jobs.update({f"segment {n}": ("segment_kernels",
                                      variant("segment_kernels", f"reductions {n}", subs))
                     for n, (subs, _) in SEG_VARIANTS.items()})
    libs = build(jobs)
    dev = torch.device("cuda", 0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    g = torch.Generator(device=dev).manual_seed(1505_05211)
    times: dict = {}
    if "segment" in only:
        segment_ablation(libs, dev, times)
    if "loops" in only:
        loop_ablation(libs["loops"], libs["loop cycles"], dev, times)
    if "flash" not in only:
        return finish(times, xor if "xor" in only else {}, libs, dev, g, stream)

    B, S, H, KV, hd = 8, 2048, 24, 8, 128
    q = torch.randn((B, S, H, hd), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((B, S, KV, hd), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((B, S, KV, hd), generator=g, device=dev).to(torch.bfloat16)
    want = flash_attention_ref(q, k, v, causal=True, block_k=512)
    o = torch.empty_like(q)
    argtypes = kernels._ENTRIES["attention_kernels"][1]["attention_flash_fwd"]

    def flash(lib):
        fn = lib.attention_flash_fwd
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        nxt = torch.zeros(1, dtype=torch.int32, device=dev)
        err = fn(0, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), nxt.data_ptr(),
                 B, S, S, H, KV, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *o.stride()[:3], ctypes.c_float(1 / math.sqrt(hd)), 1, stream())
        assert err == 0, err

    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    for rep in range(3):
        for name in FLASH:
            lib = libs[f"flash {name}"]
            flash(lib)
            torch.cuda.synchronize()
            err = float((o.float() - want.float()).abs().max())
            ms = cuda_ms(lambda: flash(lib))
            times.setdefault(f"flash {name}", []).append(ms)
            print(f"flash {name}: {ms:.6f} ms (max_abs_err {err})", flush=True)
        times.setdefault("flash sdpa", []).append(cuda_ms(sdpa))
        print(f"flash sdpa: {times['flash sdpa'][-1]:.6f} ms", flush=True)
    lib = libs["flash cycles"]
    for _ in range(3):
        flash(lib)
    torch.cuda.synchronize()
    import numpy as np

    cyc = np.zeros((1024, 2, len(STAGES)), dtype=np.int64)
    lib.read_cycles.argtypes, lib.read_cycles.restype = [ctypes.c_void_p], ctypes.c_int
    assert lib.read_cycles(cyc.ctypes.data) == 0
    cyc = cyc[:torch.cuda.get_device_properties(0).multi_processor_count]
    cycles = {}
    for c in range(2):
        mean = cyc[:, c].mean(axis=0)
        cycles[f"consumer {c}"] = {n: float(x) for n, x in zip(STAGES, mean)}
        print(f"flash cycles, consumer {c} (mean per CTA): " + ", ".join(
            f"{n} {x:.0f} ({x / mean[-1]:.3f})" for n, x in zip(STAGES, mean)))
        print(f"  per key tile: K/V wait {mean[2] / mean[9]:.0f}, S wait {mean[3] / mean[9]:.0f}, "
              f"softmax {mean[4] / mean[9]:.0f}, PV wait {mean[5] / mean[9]:.0f} cycles")
    times["flash cycles"] = cycles
    del q, k, v, o, want, qt, kt, vt
    return finish(times, xor if "xor" in only else {}, libs, dev, g, stream)


def finish(times: dict, xor: dict, libs: dict, dev, g, stream) -> int:
    """The XOR variants (if any), then the card's name and every time."""
    if not xor:
        return report(times)
    a = torch.randint(-2**31, 2**31 - 1, (32768, 8, 128), dtype=torch.int32, device=dev,
                      generator=g)
    b = torch.randint(-2**31, 2**31 - 1, (32768, 8, 128), dtype=torch.int32, device=dev,
                      generator=g)
    out = torch.empty_like(a)
    ref = torch.bitwise_xor(a, b)

    def xor_call(lib):
        fn = lib.block_xor_delta
        fn.argtypes = kernels._ENTRIES["block_kernels"][1]["block_xor_delta"]
        fn.restype = ctypes.c_int
        assert fn(0, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel() // 4, stream()) == 0

    for rep in range(3):
        times.setdefault("xor torch.bitwise_xor", []).append(
            cuda_ms(lambda: torch.bitwise_xor(a, b)))
        for name in xor:
            lib = libs[f"xor {name}"]
            out.zero_()
            xor_call(lib)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise SystemExit(f"xor {name}: not bit-identical")
            times.setdefault(f"xor {name}", []).append(cuda_ms(lambda: xor_call(lib)))
        print("  ".join(f"{n} {t[-1]:.6f}" for n, t in times.items() if n.startswith("xor")),
              flush=True)
    return report(times)


def report(times: dict) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"card": smi, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
