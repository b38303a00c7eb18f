#!/usr/bin/env python3
"""Drive the PyTorch port's store, service, solver, LM-serving (dense, MoE, MLA, recurrent, encoder-decoder; the expert-parallel MoE on a 1 x 1 NCCL mesh) and training (every family; the dots remat policy) paths, its kernel auditor, its CLIs, its example twins and its mesh runtime on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It needs a CUDA device, ``nvcc`` and the checkout's ``src/``; without them it
exits non-zero and prints no result.  It imports ``repro_torch``, torch and
numpy only, and builds the CUDA kernels from the checkout's sources on first
use (into ``build/``).  Phases:

(a) Kernel checks.  Each CUDA kernel is run at the shapes the main path gives
    it and held bit for bit against its plain PyTorch version on the card
    (edge cases too: duplicate rows across and within chain steps, padding,
    an empty chain).  Each is timed beside its plain version, its bound and,
    for the sparse scatter, ``torch.index_copy`` as the library yardstick.
    The XOR delta and the block hash are held the same way at one 128 MiB
    leaf and at 1, 255 and 257 blocks of full-range int32 data (the hash
    must wrap mod 2**32), on equal inputs (a zero delta) and for
    self-inversion, and timed; the XOR beside ``torch.bitwise_xor``.
(b) Commits.  A ``Repository`` in a temporary directory under ``build/``
    takes a dataset of ~509 MiB per version (six leaves, six dtypes, one
    leaf whose size is not a multiple of 4 KiB, three leaves of equal block
    count): a root, 24 commits on ``main`` that each change 0.5% of the
    blocks of two leaves, a mid-chain reshape (full rewrite) and a deleted
    leaf (tombstone), and a 4-commit branch off the middle, with a cache
    budget of three versions.
(c) Checkouts.  The store is reopened with no cache; the main and branch tips
    are checked out cold through the fused chain kernel and through the
    one-hop sparse kernel, then ``checkout_many`` of both tips and a mid
    version.  Every tree is compared byte for byte with numpy ground truth
    kept on the host.
(d) Breakdown.  The host steps of a commit, timed one by one, and one cold
    checkout under the port's span tracer and ``torch.profiler`` (device
    busy and idle share).
(e) Segment kernel checks.  The solvers' reductions (segment min / argmin
    over rows, the global min/argmin) at the main path's shapes — the
    16,384 x 32 in-edge matrix of a 16,000-version graph, a 16,384-element
    LMG candidate vector and Prim/MP key — and in edge cases (ties,
    all-+inf rows, NaN, -inf, rows holding both signed zeros, widths 1, 8,
    19, 24, 32, 37, 40 and 200, a single row, contiguous views that are not
    16-byte aligned, lengths 2**20 + 3 and others that are not a multiple of
    128 with the minimum in the scalar head or tail, two streams at once),
    each held bit for bit (a float's sign of zero included) against its
    plain version and timed beside its bound, ``torch.amin`` /
    ``torch.argmin`` / ``torch.min`` and an empty kernel's time (the launch
    floor); ``torch.profiler`` must see one ``cudaLaunchKernel`` a
    ``min_argmin_1d`` call.  Then the Prim and Modified-Prim step
    loops (one launch a solve), bit for bit in every state array, on phase
    (f)'s graphs at 2,000 and 16,000 versions and in edge cases (ties, NaN
    keys, unreachable versions, widths 40 and above 1,024, a single vertex,
    2**21 rows of width 8 for 48 steps), timed at 16,000 beside the plain
    loop, the bytes bound and the latency floor (``segment_loop_floor``).
(f) Solvers at n = 16,000 (``generate_flat``, the DC-like shape of the
    solver-scale sweep; undirected for Prim): Problem 2 (SPT), Problem 1
    undirected (Prim), Problem 3 (LMG) at 1.05 x C_min, Problem 6 (MP) at
    1.5 x the SPT's max recreation, each through ``optimize`` with
    ``backend="torch"`` on the card, then on the CPU (the plain versions),
    then with ``backend="numpy"``.  The card's tree must equal the CPU
    torch tree; the parents that differ from the numpy tree are counted
    (f32 selection may break near-ties the other way) beside both f64
    objectives; Prim and MP must launch their loop kernel once a solve
    and ``min_argmin_1d`` never.  Then Prim and MP run at n = 500 and
    2,000 under torch.profiler (after the counted runs): the device's busy
    share, and the host synchronisations and kernel launches, which must
    not grow with the steps.
(g) Store repack.  A fresh ``Repository`` of 64 versions of ~4 MiB in a
    branching history (four dtypes, 0.5% of blocks edited per commit) is
    committed and its cost graph measured (counted as one phase), then
    repacked with Problem 3 (LMG) and then Problem 6 (MP) through specs
    that name no backend: the default, ``"torch"``, selects on the store's
    card.  Every version is then checked out and compared byte for byte
    with host ground truth.

(h) Dense-LM serving.  First the flash-attention kernel against its plain
    version on unit-normal bf16 inputs (max abs error <= 2e-2 and <= 2e-2
    of the row's max |want|; a kernel that skipped the first KV tile, made
    by SDPA with a mask, must land above that limit), and bit-equal across
    two calls, at the serving shape (B 8, S 2048, H 24, KV 8, hd 128,
    causal), at S = 1152, at minicpm-2b's heads (g = 1, hd 64), at
    starcoder2-7b's (g = 9, at B 2 and 8), non-causal, with a softmax_scale
    override, at S = 128, at hd 32, with q, k, v as strided views of one
    fused QKV tensor, at S = 200 (called directly: keys past a tile) and at
    Sq = 128 against Sk = 2048, and at SeamlessM4T-medium's encoder (B 8,
    S 1024, 16 heads over 16 of 64, non-causal); timed at the serving shape
    beside its bound, its plain version and ``scaled_dot_product_attention``
    (the yardstick; never on the path), and beside SDPA and its bound at
    phase (n)'s shape, S = 1152, hd 64, g = 9 and the encoder's.
    ``_full_attention`` at hd 256 and at 72 query heads a KV head (S = 128)
    must take the chunked softmax: no flash launch, no error.
    Then minitron-4b at its full width and depth (5.1 B parameters, drawn
    on the card from a seeded generator): a ``ServeEngine`` of batch 8
    answers three greedy requests of 32 new tokens with seeded random
    prompts of 2048, 1152 and 1000 tokens, which must launch the kernel 32,
    32 and 0 times (one prefill each; decode and the prompt that is not a
    multiple of 128 take the chunked softmax).  Each request is held against
    teacher forcing (see ``hold_to_teacher``), and one prefill and one decode
    step run under torch.profiler.

(i) The dataset service.  A ``Repository`` on the card of 64 versions of
    ~8 MiB (phase (b)'s leaves cut to 1/64; a branch every 4 commits; a
    cache of 8 versions) is served through ``repo.serve(readers=4,
    batch_window_s=0.002, fsck_interval_s=5, fsck_sample=4)`` under an
    enabled tracer: a closed-loop warm-up measures the throughput, then 300
    open-loop zipfian requests (s = 1.1, 8% commits) arrive at half that
    rate, with a Problem 6 repack midway that must run on the card.  Every
    served tree is compared with host ground truth (a sha256 per leaf); a
    final ``svc.fsck()`` must report no gating finding; the exported Chrome
    trace must validate.  It prints p50/p99 latency, QPS, the coalescing,
    batching and warm-hit counters, the tradeoff monitor's last sample, the
    span-versus-track reconciliation and the device idle share.
(j) The XOR and hash ops on the main path's data: for every leaf of phase
    (b)'s main tip and its parent, ``ops.xor_apply(parent,
    ops.xor_encode(parent, tip))`` must equal the tip byte for byte,
    ``ops.block_hashes(tip)`` its plain version, and every block the
    changed-block mask marks unchanged must hash alike in both versions.

(k) Training at full width.  ``repro_torch.launch.train.train`` trains
    minicpm-2b at its full width and depth (40 layers, d 2304, 36 heads of
    64, d_ff 5760, vocab 122,753, tied embeddings; 2.725 B parameters drawn
    on the card from a seeded generator) for 5 steps of 8 x 1024 tokens with
    the WSD schedule and no saves.  It prints each step's loss, grad norm,
    lr and wall (CUDA events, step end to step end), the tokens/s of steps
    1-4, the peak device memory and the step's bound (the matmul operations
    of 3 forward passes, counted from the shapes by ``forward_flops``, over
    989 TFLOP/s; the remat's recompute, a fourth, is printed on its own); one
    more step runs under torch.profiler (busy time, idle share, top
    kernels).  The run fails if a loss or grad norm is not finite, if
    ``flash_attention`` launched (training takes the chunked softmax, as the
    JAX package does), if one backward on step 0's batch leaves a parameter
    without a finite gradient or an attention projection (wq, wk, wv, wo)
    with an all-zero one, or if the chunked cross entropy of step 0's hidden
    states differs from the unchunked by more than ``CE_RTOL`` relative, or
    its gradient with respect to those states by more than ``CE_GRAD_RTOL``
    of the norm.
(l) The versioned-checkpoint loop of examples/train_versioned.py on the
    card: minicpm-2b reduced, 60 steps of 8 x 128, a save every 10 steps,
    a preemption at step 29 (emergency save), a restart that resumes from
    the store, then ``mgr.repack()`` (Problem 6, θ = 30 s, on the card) and
    a cold restore of every save from a freshly opened store.  Every
    restored leaf must equal the host copy taken at its save (a sha256 per
    leaf), the loss must fall, the trainer's 60 batches must equal an
    uninterrupted pipeline's, no background repack may have failed, and
    ``changed_block_mask`` and ``mp_loop`` must launch.  Each Adam step
    changes every 4 KiB block of params and moments, so every save is
    stored whole and the loop's restores apply no delta; the delta-apply
    kernels are driven by a versioned corpus (16 MiB of token ids and two
    cleaning passes that rewrite 1% of its blocks) read cold through
    ``VersionedDatasetPipeline``, whose batches are held against the host's
    tokens.  Then minitron-4b reduced trains 4 steps with ``grad_accum=2``
    and compressed gradients: the losses must be finite.  It prints the
    bytes stored before and after the repack, the max restore cost, one
    save's bytes and the save, repack and restore walls.

(m) DeepSeek-V3 serving (MLA, a shared and 256 routed experts, top 8).
    The published widths (d 7168, 128 heads, q/kv LoRA ranks 1536/512,
    rope/nope/v dims 64/128/128, expert d_ff 2048, dense d_ff 18432, vocab
    129,280), with the depth cut from 61 to 5 layers because the card's
    80 GB hold no more: 3 dense MLA layers and 2 MLA + MoE layers, plus the
    MTP head's parameters (27.3 B, 54.6 GB bf16, drawn on the card from a
    seeded generator; the tree must number ``count_params`` less the MTP
    block's GQA-for-MLA miscount, ROADMAP Queue 3).  The first MoE layer's
    real input (1 x 1024 tokens) goes through ``moe_block`` and through
    ``moe_block_plain``, each token's experts summed one by one with no
    dispatch, drop-free (buffers (256, 1, 1025, 7168)): every token within
    2e-2 of the plain sum's norm; at the published capacity factor the plain
    sum must single out the tokens that lost a route.  Two greedy requests of
    2 x 512 tokens and 16 new, drop-free, one through each MLA cache form
    (full ``{"k", "v"}`` and the compressed latent), are each held against
    teacher forcing on their own routes (``moe_teacher_force``: every MoE
    layer of the teacher is the plain sum on the experts the engine chose,
    so near-tie route flips, counted and printed, cannot hide a dispatch
    fault), and against each other.  Then, at the published cf 1.25 (C =
    40), a timed prefill of 4 x 1024 tokens and 16 decode steps in each cache
    form: walls, peak memory, the share of routes dropped, and one traced
    decode step (idle share, top kernels, and the expert weights every step
    reads: C = 1 slot per expert runs all 256 experts of both MoE layers).
    MLA takes the chunked softmax, as the JAX package's does: no kernel of
    the repo is on this path.  The layer check runs the expert-parallel
    form too (``moe_block_ep`` on phase (u)'s 1 x 1 NCCL mesh) against the
    plain sum over the EP form's own routes (its router cast to bf16, as the
    JAX module's), drop-free: every token within 2e-2, two all-to-alls and
    one all-gather a call, a planted fault (each expert's tokens handed to
    the next) above 2e-2, and the tokens whose top-k sets the bf16 and the
    f32 router choose differently counted.
(n) Phi-3.5-MoE serving (GQA 32 / 8 heads of 128, 16 experts, top 2, d
    4096, expert d_ff 6400, vocab 32,064), the depth cut from 32 to 16
    layers (21.1 B, 42.1 GB).  The same layer check; a ServeEngine of batch
    4 answers greedy requests of 16 tokens with prompts of 2048 tokens (the
    prefill takes the flash kernel, one launch a layer) and 1000 (the
    chunked softmax), drop-free, each held against teacher forcing as in
    (m), the EP layer check too; then the 2048-token request again with
    ``moe_impl="ep"`` on the mesh, drop-free: 16 flash launches, two
    all-to-alls a MoE layer call, held against teacher forcing over the EP
    form's own routes, its prefill and decode walls beside the dispatch's on
    the same prompt; then a timed prefill of 4 x 2048 and 16 decode steps at
    cf 1.25, one decode step traced.  The flash launches of the phase are
    counted.
(o) The recurrent families at their published widths and full depth, each
    alone on the card, weights drawn there from a seeded generator (the tree
    must number ``count_params``, plus for RWKV-6 the twelve D-vectors a
    layer it leaves out, ROADMAP Queue 3).  RecurrentGemma-9B (38 layers:
    12 x (RG-LRU, RG-LRU, local attention) + 2 RG-LRU, d 4096, lru width
    4096, 16 heads over 1 KV head of 256, window 2048, d_ff 12288, vocab
    256,000; 7.660 B): the RG-LRU scan on a real layer input against a
    sequential f64 recurrence; a windowed attention layer at its real input,
    whose 3072-token prefill and each of 16 decode steps after it must leave
    every position q of the window at ring slot q % W bit for bit (its
    outputs printed beside the windowed forward's, and the first step's
    beside the same step on the ring laid out as the JAX package lays it;
    at W = 2048 those gaps are rounding either way); then a ServeEngine
    of batch 4 answers greedy requests of 16 new tokens with prompts of 2048
    (= W) and 3072 tokens (3072 % 2048 = 1024: the layout the reference gets
    wrong).  RWKV-6 3B (32 layers, d 2560, 40 heads of 64, d_ff 8960, vocab
    65,536; 3.0995 B): the chunked WKV against the sequential scan on a real
    layer input; requests of 1024 tokens through the scan form and 2048
    through the chunked form, whose prefill logits are held against the scan
    form's on the same prompt within FORMS_TOL of their norm, and the chunked
    form with a planted fault (its bonus term u left out) must land above
    that limit.  Each request is held against teacher forcing
    (``hold_to_teacher``: the prefill at 2e-2 against a teacher over the
    prompt alone, each decode step within 5e-2 or twice the gap of two
    routes to the same logits: the RG-LRU stepped sequentially, or the other
    WKV form); it prints each request's prefill wall, 16 decode steps,
    peak memory and flash launches (0: the hybrid's attention is windowed at
    hd 256, RWKV has none), and one traced decode step beside the bytes it
    needs (every weight but the embedding table, the ring or state).
(p) SeamlessM4T-medium serving at its published widths and full depth, no
    cut (12 encoder and 12 decoder layers, d 1024, 16 heads over 16 of 64,
    d_ff 4096 GELU, vocab 256,206; 0.877 B, drawn on the card from a seeded
    generator; the tree must number ``count_params`` plus the vocab's
    padding).  A ServeEngine of batch 8 and ``enc_len`` 1024 answers three
    greedy requests of 32 new tokens on seeded N(0, 1) bf16 frames (the stub
    frontend's output): 1024 frames and a 128-token prompt, 1024 and 100,
    and 1000 frames (fewer than enc_len) and 128, which must launch the
    flash kernel exactly 24, 12 and 12 times (the encoder's non-causal
    self-attention at S_enc % 128 = 0, the decoder's prefill at prompt %
    128 = 0; decode and the cross-attention take the chunked softmax).  Each
    request is held against teacher forcing (``hold_to_teacher``: the
    prefill against a teacher over the prompt alone, the decode steps
    against teachers over the decoder's tokens as they are and padded to a
    multiple of 128).  One prefill and one decode step run under
    torch.profiler: walls, idle share, kernel classes and peak memory, the
    step beside the bytes it needs and the operations of the cross K/V that
    every decoder layer recomputes from the encoder output at every step.
(q) Training the MoE and MLA families on the card, weights drawn there from
    a seeded generator.  (q1) ``make_train_step`` on Phi-3.5-MoE at its
    published widths, cut from 32 to 2 layers (2.865 B parameters, 34.4 GB
    of train state at 12 bytes a parameter): 5 steps of 4 x 2048 tokens at
    the published cf 1.25 (C = 320), WSD schedule.  (q2) The same on
    DeepSeek-V3 cut to its 3 dense MLA layers and the MTP head (4.294 B,
    51.5 GB; one MoE layer more would be 11.3 B): 5 steps of 2 x 1024.
    Each prints every step's loss, grad norm, lr, wall (CUDA events) and
    share of routes dropped, tokens/s, the peak memory and the bound (3
    forward passes of ``forward_flops``: the dispatch's E x B x (C +
    1) buffer rows, MLA's projections and its QK^T at nd + rd, the MTP head,
    over 989 TFLOP/s), and one traced step's busy share and kernel classes;
    it fails if a loss or grad norm is not finite, ``flash_attention``
    launched, an MoE layer's recompute in the backward pass chose other
    experts than its forward, a backward on a fresh batch leaves a leaf
    without a finite gradient or an attention, MoE or MTP leaf with an
    all-zero one, the loss is not the main CE plus 0.3 x the MTP CE, or a
    chunked CE (main, MTP) parts from the unchunked (``ce_check``).  (q1)
    then holds the first MoE layer's backward on a real layer input at
    drop-free capacity against ``moe_block_plain``'s, every leaf within
    ``Q_GRAD_TOL`` of its norm, and the route weights detached (a planted
    fault) must land above it.  (q3) One DeepSeek-V3 MoE layer at its
    published widths (256 experts top 8, a shared expert: 11.3 B parameters,
    no optimizer): one forward and backward of 1 x 512 seeded inputs at
    drop-free capacity, four experts' router columns zeroed so that no route
    reaches them; x's, the router's and the shared expert's gradients within
    ``Q_GRAD_TOL`` of ``moe_block_plain``'s (run with the expert stacks
    frozen), every expert stack's gradient finite, exactly zero for the
    experts no route reached and non-zero for the rest; then the same layer,
    input and cotangent through ``moe_block_ep`` on the mesh (two
    all-to-alls forward, two back), held the same way against the plain sum
    over the EP form's own routes.  (q4)
    ``launch.train.train`` on reduced DeepSeek-V3 with a save every 4 steps,
    a preemption and a resume; every save restored cold must equal its host
    copy leaf for leaf (sha256; f32 routers, the MTP head), and
    ``changed_block_mask`` must launch.

(r) Training the recurrent and enc-dec families at their published widths,
    weights drawn on the card from a seeded generator, through
    ``make_train_step`` (WSD, 5 steps, each step's wall, tokens/s, the
    bound, the peak, a traced step, one backward with every leaf's gradient
    finite): (r1) RecurrentGemma-9B cut to 12 of 38 layers, 2 x 4096, and
    the RG-LRU scan's backward against an f64 recurrence beside a planted
    fault (the h0 fold dropped); (r2) RWKV-6 3B at full depth, 4 x 2048 in
    the chunked WKV, the chunked form's backward against the scan's on a
    real layer input, then one 1 x 512 step in the scan form with the whole
    model's gradients against the chunked form's, each beside a planted
    fault (the bonus u dropped); (r3) SeamlessM4T-medium at full depth, 8 x
    (1024 seeded frames, 1024 tokens), flash 0, every encoder and
    cross-attention leaf's gradient non-zero; (r4) the reduced driver on
    both recurrent archs with saves, a preemption and a resume, every save
    restored by sha256.
(s) (s1) Phase (k)'s run (minicpm-2b at full width and depth, 5 steps of 8
    x 1024 through ``launch.train.train``) under ``REPRO_REMAT_POLICY=dots``,
    which saves the layers' no-batch weight products (q, k, v, o, gate, up)
    instead of recomputing them: each step's wall, tokens/s, the bound (as
    (k)), the recompute the policy leaves out and the bytes of its saved
    products, the peak device memory, one traced step's busy share and
    kernel classes; then one backward on the same state and batch under
    ``full`` and under ``dots``, whose gradients must be the same bits, with
    each backward's peak.  (s2) The CLIs, each a subprocess whose exit status
    is checked: ``python -m repro_torch.analysis audit --json`` on the card
    (every target ran, no finding beyond the committed
    ``analysis_baseline_torch.json``: 0), the same over a planted wrapper
    alone that XORs into its argument through a launch (``audit.arg-write``
    from the bytes: 1), ``fsck --synthetic`` (0), fsck of the synthetic
    store committed on the card with one object deleted
    (``fsck.missing-object``: 1), ``python -m repro_torch.obs summary
    --synthetic --json`` and ``overhead`` (the disabled tracer's share of a
    warm checkout, gated at ``S_OVERHEAD_BUDGET_PCT`` and printed beside the
    card's name and power limit).
(t) The example twins, each ``examples/<name>_torch.py``'s ``main(["--device",
    "cuda"])`` in this process, the launch counters zeroed before it and read
    after it: quickstart (Figure 1's grid, the spec grid on ``dc_like(150,
    seed=7)``, the tensor ``Repository`` with a P6 repack), dataset_versions
    (four 200,000-token shards, cleaning, dedup, ``VersionedDatasetPipeline``),
    serve_batched (8 coalesced checkouts, a batch of 5, a warm repeat),
    serve_dataset (commits between reads, fsck, a P2 repack, under the tracer)
    and branching_finetune (reduced minitron-4b fine-tuned on two branches, a
    soup, 26 checkouts, a P3 repack).  Each twin's kernels must launch, and
    its invariants hold: quickstart's Figure 1 and frontier numbers and
    dataset_versions' bytes stored and diff equal the same twin's on the CPU;
    7 of 8 coalesced and 1 batch dispatch; 0 invalidations and a purge; 25 of
    26 checkouts from the cache.  Then the isolation contract on phase (b)'s
    ``tokens/i8`` (edited) and ``mask/valid`` (shared) leaves: a write into a
    warm checkout, into one result of a batch and into one of two coalesced
    service results must leave every later tree equal to its sha256.

(u) The mesh runtime on the card, before (m): ``make_host_mesh("cuda")``,
    the 1 x 1 ``("data", "model")`` mesh over NCCL at world size 1 (the
    backend and NCCL's version logged; nothing falls back to gloo), which
    (m), (n) and (q) reuse; ``compressed_psum`` over "data" on a 64 MiB f32
    tensor, bit-equal to ``quant_dequant``, both timed; a small train state
    (reduced Phi-3.5-MoE's params and moments) committed and restored with
    ``shardings=tree_spec(param_axes(...))`` onto the mesh, every DTensor's
    local tensor bit-equal to the plain restore's leaf.

Phases (e) and (h)'s kernel checks run right after (a), so that every
kernel is checked before the main path starts.  The launch counters of the
kernels are set to 0 before each main-path phase and read after it; a
kernel its phase should use that launched no time fails the run, as does
any mismatch.  Phases (b), (c), (f), (g), (i), (j), (l), (h)'s requests,
(u), (m), (n), (o), (p), (k), (q), (r), (s) and (t) are the main path ((j) runs
after (d), on (b)'s ground truth; (u) and (m) to (s) run last, each alone on
the card's memory); the launches of the kernel checks, which compare kernels with their
plain versions, are not counted.  ``--only LETTERS`` runs a subset (a development aid; it prints no
result line).  The last lines are the card's name and power limit
(``nvidia-smi``), one JSON object with each kernel's numbers, and the
result line ``{"ok": true, "device": {...}}``; the segment kernels' entries
of that object also carry ``launch_floor_ms``.
"""

from __future__ import annotations

import contextlib
import faulthandler
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
SEED = 1505_05211
STACKS_AFTER_S = 1140  # every thread's stack to standard error, if still running
BLOCK = 4096

# name -> (dtype, shape): ~509 MiB per version at the dataset's own widths
LEAVES = {
    "features/dense": ("float32", (32768, 1024)),    # 128 MiB, 32768 blocks
    "features/half": ("float16", (32768, 2048)),     # 128 MiB, 32768 blocks
    "embeddings/bf16": ("bfloat16", (32768, 2048)),  # 128 MiB, 32768 blocks
    "labels/ids": ("int64", (8_000_001,)),           # 64,000,008 B: ragged
    "tokens/i8": ("int8", (50_000_000,)),            # 47.7 MiB
    "mask/valid": ("bool", (16_777_216,)),           # 16 MiB
}
PAIRS = (("features/dense", "features/half"), ("embeddings/bf16", "labels/ids"))
MAIN_COMMITS = 24
BRANCH_COMMITS = 4
FORK_AT = 12           # branch "dev" forks off main's 12th commit
RESHAPE_AT = 8         # main commit that reshapes labels/ids (full rewrite)
TOMBSTONE_AT = 18      # main commit that deletes mask/valid
CHANGED_SHARE = 0.005  # of a leaf's blocks, per edit
PHASES = "abcdefghijklmnopqrstu"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# ------------------------------------------------------------------ dataset
def make_dataset(rng: np.random.Generator, leaves: dict = LEAVES) -> dict:
    """Host ground truth: name -> numpy array (bfloat16 held as uint16)."""
    import torch

    out = {}
    for name, (dtype, shape) in leaves.items():
        n = int(np.prod(shape))
        if dtype == "bfloat16":
            f = torch.from_numpy(rng.standard_normal(n, dtype=np.float32))
            arr = f.to(torch.bfloat16).view(torch.uint16).numpy()
        elif dtype in ("float32", "float16"):
            arr = rng.standard_normal(n, dtype=np.float32).astype(dtype)
        elif dtype == "bool":
            arr = rng.random(n, dtype=np.float32) < 0.5
        else:
            info = np.iinfo(dtype)
            arr = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
        out[name] = arr.reshape(shape)
    return out


def edit_blocks(rng: np.random.Generator, arr: np.ndarray) -> np.ndarray:
    """A copy of ``arr`` with one byte changed in 0.5% of its 4 KiB blocks."""
    new = arr.copy()
    raw = new.reshape(-1).view(np.uint8)
    nblocks = -(-raw.size // BLOCK)
    rows = rng.choice(nblocks, max(1, int(nblocks * CHANGED_SHARE)), replace=False)
    pos = np.minimum(rows * BLOCK + rng.integers(0, BLOCK, rows.size), raw.size - 1)
    raw[pos] ^= rng.integers(1, 256, rows.size).astype(np.uint8)
    return new


def leaf_tensor(name: str, arr: np.ndarray):
    """A ground-truth leaf as a tensor sharing its memory (bfloat16 leaves
    are held as uint16 on the host)."""
    import torch

    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if LEAVES[name][0] == "bfloat16" else t


def as_payload(tree: dict) -> dict:
    """Nested payload of tensors sharing the ground truth's memory."""
    payload: dict = {}
    for name, arr in tree.items():
        group, leaf = name.split("/")
        payload.setdefault(group, {})[leaf] = leaf_tensor(name, arr)
    return payload


def same_tree(got: dict, want: dict, what: str) -> None:
    import torch

    check(sorted(got) == sorted(want),
          f"{what}: leaves {sorted(got)} != {sorted(want)}")
    for name, arr in want.items():
        t = got[name]
        check(tuple(t.shape) == arr.shape, f"{what}/{name}: shape {tuple(t.shape)} != {arr.shape}")
        check(t.element_size() == arr.itemsize, f"{what}/{name}: dtype {t.dtype} != {arr.dtype}")
        want_u8 = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
        check(torch.equal(t.contiguous().reshape(-1).view(torch.uint8), want_u8),
              f"{what}/{name}: bytes differ")


# ---------------------------------------------------------- (a) kernel checks
def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # hold the device (~0.5 ms per iteration at ~2 GHz) while the host
    # enqueues the launches, so that the events time the device's work and
    # not the host's launch overhead, which hides small kernels; a shared
    # host stalls for milliseconds at times (0.1 ms per iteration let a
    # 3 us kernel read 0.34 ms once)
    torch.cuda._sleep(iters * 1_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_call_ms(fn, iters: int = 200) -> float:
    """Wall time of one call from the host, launch overhead included: what a
    loop of dependent calls pays per step."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def max_abs_err(got, want) -> float:
    import torch

    check(got.shape == want.shape, f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    torch.cuda.synchronize()
    return float((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0.0


def kernel_checks(dev) -> list:
    """Phase (a): each kernel against its plain version at the main path's
    shapes, bit for bit, and timed."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.block_diff import changed_block_mask
    from repro_torch.kernels.chain_apply import chain_delta_apply, chain_delta_apply_batched
    from repro_torch.kernels.sparse_apply import sparse_delta_apply

    g = torch.Generator(device=dev).manual_seed(SEED)

    def rand_blocks(n):
        return torch.randint(-(2**31), 2**31 - 1, (n, 8, 128), dtype=torch.int32,
                             device=dev, generator=g)

    dtype, shape = LEAVES["features/dense"]
    nb = int(np.prod(shape)) * np.dtype(dtype).itemsize // BLOCK  # 32768
    k = int(nb * CHANGED_SHARE)                      # rows one commit changes
    rows_of = lambda n, m: torch.randperm(n, device=dev, generator=g)[:m].to(torch.int32)
    results = []

    # changed_block_mask: a commit's diff of one 128 MiB leaf
    a = rand_blocks(nb)
    b = a.clone()
    changed = rows_of(nb, k).long()
    b[changed, 3, 5] ^= 1
    got, want = changed_block_mask(a, b), ref.changed_block_mask_ref(a, b)
    err = max_abs_err(got, want)
    check(err == 0 and int(got.sum()) == k, "changed_block_mask disagrees with its plain version")
    check(int(changed_block_mask(a, a.clone()).sum()) == 0, "changed_block_mask: identical inputs")
    check(int(changed_block_mask(a, a ^ 1).sum()) == nb, "changed_block_mask: all rows changed")
    results.append({
        "name": "changed_block_mask", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/delta_kernels.cu",
        "replaces": "src/repro/kernels/block_diff.py:31",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: changed_block_mask(a, b)),
        "plain_ms": cuda_ms(lambda: ref.changed_block_mask_ref(a, b)),
        "bound_ms": bound_ms(2 * nb * BLOCK + nb * 4), "bound_by": "bytes",
        "library_ms": None,
    })
    del a, b

    # sparse_delta_apply: one hop of a stepwise checkout (a trimmed wire
    # delta: distinct rows, no padding), plus padding and out-of-range rows
    base = rand_blocks(nb)
    blocks = rand_blocks(k)
    idx = rows_of(nb, k)
    got, want = sparse_delta_apply(base, blocks, idx), ref.sparse_delta_apply_ref(base, blocks, idx)
    err = max_abs_err(got, want)
    check(err == 0, "sparse_delta_apply disagrees with its plain version")
    lib = torch.index_copy(base, 0, idx.long(), blocks)
    check(torch.equal(lib, got), "index_copy disagrees with sparse_delta_apply")
    pad_idx = idx.clone()
    pad_idx[::3] = -1
    pad_idx[1::7] = nb + 5
    check(torch.equal(sparse_delta_apply(base, blocks, pad_idx),
                      ref.sparse_delta_apply_ref(base, blocks, pad_idx)),
          "sparse_delta_apply: padding rows")
    idx64 = idx.long()
    results.append({
        "name": "sparse_delta_apply", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/delta_kernels.cu",
        "replaces": "src/repro/kernels/sparse_apply.py:34",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: sparse_delta_apply(base, blocks, idx)),
        "plain_ms": cuda_ms(lambda: ref.sparse_delta_apply_ref(base, blocks, idx)),
        "bound_ms": bound_ms(2 * nb * BLOCK + k * (BLOCK + 4)), "bound_by": "bytes",
        "library_ms": cuda_ms(lambda: torch.index_copy(base, 0, idx64, blocks)),
    })
    del base, blocks, lib

    # chain_delta_apply_batched: the main tip's checkout of the three 128 MiB
    # leaves edited on alternate commits (12 steps of k rows each, padded to
    # the slot bucket): duplicate rows across steps, padding at the tail
    steps = MAIN_COMMITS // 2
    slots = 1 << (steps * k - 1).bit_length()
    leaves = 3
    bases = rand_blocks(leaves * nb).reshape(leaves, nb, 8, 128)
    cblocks = rand_blocks(leaves * slots).reshape(leaves, slots, 8, 128)
    cidx = torch.full((leaves, slots), -1, dtype=torch.int32, device=dev)
    for leaf in range(leaves):
        for s in range(steps):
            cidx[leaf, s * k:(s + 1) * k] = rows_of(nb, k)
    cidx[:, k // 2] = cidx[:, 3 * k + 1]  # the same row in two steps
    offs = torch.arange(leaves, dtype=torch.int32, device=dev)[:, None] * nb

    def chain_plain():  # the batched wrapper's row offsets, then the plain fold
        flat_idx = torch.where(cidx >= 0, cidx + offs, -1).reshape(-1)
        return ref.chain_delta_apply_ref(
            bases.reshape(-1, 8, 128), cblocks.reshape(-1, 8, 128), flat_idx
        ).reshape(bases.shape)

    got = chain_delta_apply_batched(bases, cblocks, cidx)
    err = max_abs_err(got, chain_plain())
    check(err == 0, "chain_delta_apply_batched disagrees with its plain version")
    for i in range(leaves):
        check(torch.equal(got[i], ref.chain_delta_apply_ref(bases[i], cblocks[i], cidx[i])),
              f"chain_delta_apply_batched: leaf {i} differs from its own chain")
    # single-leaf form, duplicates within one step, an empty chain, all padding
    one_idx = torch.randint(0, 64, (4, 16), dtype=torch.int32, device=dev, generator=g)
    one_idx[:, ::5] = -1
    one_blk = rand_blocks(64).reshape(4, 16, 8, 128)
    small = rand_blocks(64)
    check(torch.equal(chain_delta_apply(small, one_blk, one_idx),
                      ref.chain_delta_apply_ref(small, one_blk, one_idx)),
          "chain_delta_apply: duplicates within and across steps")
    empty = torch.zeros((0,), dtype=torch.int32, device=dev)
    check(torch.equal(chain_delta_apply(small, one_blk[:0].reshape(0, 8, 128), empty), small),
          "chain_delta_apply: empty chain")
    check(torch.equal(chain_delta_apply(small, one_blk, torch.full_like(one_idx, -1)), small),
          "chain_delta_apply: all padding")
    winners = int(torch.unique((cidx + offs)[cidx >= 0]).numel())
    results.append({
        "name": "chain_delta_apply", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/delta_kernels.cu",
        "replaces": "src/repro/kernels/chain_apply.py:76",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: chain_delta_apply_batched(bases, cblocks, cidx)),
        "plain_ms": cuda_ms(chain_plain),
        "bound_ms": bound_ms(2 * leaves * nb * BLOCK + winners * BLOCK + leaves * slots * 4),
        "bound_by": "bytes",
        "library_ms": None,
    })
    del bases, cblocks, got
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    results += block_op_checks(dev, rand_blocks, nb)
    for r in results:
        log(f"kernel {r['name']}: max_abs_err {r['max_abs_err']} ms {r['ms']:.6f} "
            f"plain_ms {r['plain_ms']:.6f} bound_ms {r['bound_ms']:.6f} "
            f"library_ms {r['library_ms']}")
    return results


def block_op_checks(dev, rand_blocks, nb: int) -> list:
    """Phase (a), the XOR delta and the block hash: bit for bit against
    their plain versions at one 128 MiB leaf (``nb`` blocks) and at 1, 255
    and 257 blocks, on full-range int32 data; equal inputs, self-inversion,
    a hash that must wrap; neither wrapper writes into its arguments."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.block_diff import block_hash, hash_coefficients
    from repro_torch.kernels.xor_delta import xor_delta

    coef = torch.from_numpy(hash_coefficients()).to(dev)
    xor_err = hash_err = 0.0
    for n in (nb, 1, 255, 257):
        a, b = rand_blocks(n), rand_blocks(n)
        a0, b0 = a.clone(), b.clone()
        d = xor_delta(a, b)
        xor_err = max(xor_err, max_abs_err(d, ref.xor_delta_ref(a, b)))
        check(torch.equal(xor_delta(a, d), b), f"xor_delta: a ^ (a ^ b) != b at {n} blocks")
        check(not bool(xor_delta(a, a.clone()).any()), f"xor_delta: a ^ a != 0 at {n} blocks")
        h = block_hash(a, coef)
        hash_err = max(hash_err, max_abs_err(h, ref.block_hash_ref(a, coef)))
        check(torch.equal(a, a0) and torch.equal(b, b0),
              f"xor_delta / block_hash wrote into an argument at {n} blocks")
        check(d.data_ptr() not in (a.data_ptr(), b.data_ptr()), "xor_delta aliased an argument")
    check(xor_err == 0, "xor_delta disagrees with its plain version")
    check(hash_err == 0, "block_hash disagrees with its plain version")
    # full-range data: the exact sums (Python integers) leave int32, so the
    # hash must be their wrap mod 2**32
    exact = (a.cpu().numpy().astype(object) * coef.cpu().numpy().astype(object)).sum(axis=(1, 2))
    wrapped = sum(1 for e in exact if not -(2**31) <= e < 2**31)
    want = [((int(e) + 2**31) % 2**32) - 2**31 for e in exact]
    check(wrapped > 0 and block_hash(a, coef)[:, 0].tolist() == want,
          "block_hash: the sums of full-range data do not wrap mod 2**32")
    log(f"phase a: block_hash wrapped {wrapped} of {a.shape[0]} exact block sums")

    a, b = rand_blocks(nb), rand_blocks(nb)
    results = [{
        "name": "xor_delta", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_kernels.cu",
        "replaces": "src/repro/kernels/xor_delta.py:31",
        "max_abs_err": xor_err,
        "ms": cuda_ms(lambda: xor_delta(a, b)),
        "plain_ms": cuda_ms(lambda: ref.xor_delta_ref(a, b)),
        "bound_ms": bound_ms(3 * nb * BLOCK), "bound_by": "bytes",
        "library_ms": cuda_ms(lambda: torch.bitwise_xor(a, b)),
    }, {
        "name": "block_hash", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_kernels.cu",
        "replaces": "src/repro/kernels/block_diff.py:69",
        "max_abs_err": hash_err,
        "ms": cuda_ms(lambda: block_hash(a, coef)),
        "plain_ms": cuda_ms(lambda: ref.block_hash_ref(a, coef)),
        "bound_ms": bound_ms(nb * BLOCK + BLOCK + nb * 4), "bound_by": "bytes",
        "library_ms": None,
    }]
    del a, b
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------ main path
class Counters:
    """The wrappers' launch counters, zeroed and read around each phase."""

    def __init__(self):
        from repro_torch.kernels import (
            block_diff,
            chain_apply,
            flash_attention,
            segment_ops,
            sparse_apply,
            xor_delta,
        )

        self.fns = {
            "changed_block_mask": [block_diff.changed_block_mask],
            "sparse_delta_apply": [sparse_apply.sparse_delta_apply],
            "chain_delta_apply": [chain_apply.chain_delta_apply,
                                  chain_apply.chain_delta_apply_batched],
            "segment_min_rows": [segment_ops.segment_min_rows],
            "segment_argmin_rows": [segment_ops.segment_argmin_rows],
            "min_argmin_1d": [segment_ops.min_argmin_1d],
            "prim_loop": [segment_ops.prim_loop],
            "mp_loop": [segment_ops.mp_loop],
            "flash_attention": [flash_attention.flash_attention],
            "xor_delta": [xor_delta.xor_delta],
            "block_hash": [block_diff.block_hash],
        }
        self.total = {name: 0 for name in self.fns}

    def zero(self) -> None:
        for fns in self.fns.values():
            for fn in fns:
                fn.launches = 0

    def read(self, phase: str, needs: tuple) -> dict:
        counts = {name: sum(fn.launches for fn in fns) for name, fns in self.fns.items()}
        for name, n in counts.items():
            self.total[name] += n
        log(f"launches {phase}: {json.dumps(counts)}")
        for name in needs:
            check(sum(counts[n] for n in name.split("|")) > 0,
                  f"{phase}: kernel {name} was never launched")
        return counts


def drive_commits(root: Path, counters: Counters, device: str = "cuda") -> dict:
    """Phase (b): the history; returns the host ground truth of the
    versions phase (c) checks out."""
    from repro_torch.store import Repository

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    tree = make_dataset(rng)
    log(f"phase b: dataset {sum(a.nbytes for a in tree.values()) / 2**20:.1f} MiB "
        f"per version, made in {time.perf_counter() - t0:.3f} s")
    budget = 3 * sum(a.nbytes for a in tree.values())
    repo = Repository(root, device=device, cache_budget_bytes=budget)
    truth = {}
    counters.zero()
    t0 = time.perf_counter()
    repo.commit(as_payload(tree), message="root")
    commit_s = [time.perf_counter() - t0]
    fork_tree = None
    for i in range(1, MAIN_COMMITS + 1):
        tree = dict(tree)
        for name in PAIRS[i % 2]:
            tree[name] = edit_blocks(rng, tree[name])
        if i == RESHAPE_AT:
            tree["labels/ids"] = tree["labels/ids"].reshape(-1, 1)
        if i == TOMBSTONE_AT:
            del tree["mask/valid"]
        t0 = time.perf_counter()
        vid = repo.commit(as_payload(tree), message=f"main {i}")
        commit_s.append(time.perf_counter() - t0)
        if i == FORK_AT:
            fork_tree, fork_vid = tree, vid
            truth["mid"] = (vid, tree)
        if i == MAIN_COMMITS - 1:
            truth["main^"] = (vid, tree)  # the tip's parent, for phase (j)
    truth["main"] = ("main", tree)
    repo.branch("dev", at=fork_vid)
    tree = fork_tree
    for i in range(1, BRANCH_COMMITS + 1):
        tree = dict(tree)
        for name in PAIRS[0]:
            tree[name] = edit_blocks(rng, tree[name])
        t0 = time.perf_counter()
        repo.commit(as_payload(tree), branch="dev", message=f"dev {i}")
        commit_s.append(time.perf_counter() - t0)
    truth["dev"] = ("dev", tree)
    repo.close()
    stored = sorted((m.stored_base is None, m.stored_bytes) for m in repo.store.log())
    log(f"phase b: {len(commit_s)} commits in {sum(commit_s):.3f} s "
        f"(root {commit_s[0]:.3f} s, others mean "
        f"{sum(commit_s[1:]) / (len(commit_s) - 1):.3f} s); stored "
        f"{repo.store.storage_bytes()} bytes, "
        f"{sum(1 for full, _ in stored if full)} full objects")
    check(sum(1 for full, _ in stored if full) == 1,
          "phase b: every commit after the root should be stored as a delta")
    counters.read("phase b (commits)", ("changed_block_mask", "chain_delta_apply"))
    return truth


def drive_checkouts(root: Path, truth: dict, counters: Counters, device: str = "cuda") -> None:
    """Phase (c): cold checkouts, fused and stepwise, and a batch."""
    from repro_torch.store import Repository

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        log(f"phase c: {label} in {time.perf_counter() - t0:.3f} s")
        return out

    for fuse, needs in ((True, ("chain_delta_apply",)), (False, ("sparse_delta_apply",))):
        repo = Repository(root, device=device, cache_budget_bytes=0, fuse_chains=fuse)
        counters.zero()
        for label in ("main", "dev"):
            ref_, want = truth[label]
            got = timed(f"checkout {label} tip (fuse_chains={fuse})",
                        lambda: repo.checkout(ref_))
            same_tree(got, want, f"{label} tip (fuse_chains={fuse})")
        counters.read(f"phase c (fuse_chains={fuse})", needs)
        repo.close()
    repo = Repository(root, device=device, cache_budget_bytes=0)
    counters.zero()
    labels = ("main", "dev", "mid")
    got = timed("checkout_many(main, dev, mid)",
                lambda: repo.checkout_many([truth[lb][0] for lb in labels]))
    for lb, tree in zip(labels, got):
        same_tree(tree, truth[lb][1], f"checkout_many {lb}")
    stats = repo.store.materializer.stats()
    log(f"phase c: checkout_many stats {json.dumps(stats)}")
    counters.read("phase c (checkout_many)", ("chain_delta_apply",))
    repo.close()


def breakdown(root: Path, truth: dict, device: str = "cuda") -> None:
    """Phase (d), after the main path: where a commit's and a cold
    checkout's time goes at full size.  The host steps of a commit are
    timed one by one; one cold fused checkout of the main tip runs under
    the port's tracer (its spans) and torch.profiler (device busy time)."""
    import hashlib

    import torch
    from torch.autograd import DeviceType

    from repro_torch.obs import Tracer, set_tracer
    from repro_torch.store import Repository, delta

    def clock(label, fn):
        t0 = time.perf_counter()
        out = fn()
        log(f"phase d: {label} {time.perf_counter() - t0:.3f} s")
        return out

    repo = Repository(root, device=device, cache_budget_bytes=0)
    objects = repo.store.objects
    flat = clock("flatten_payload", lambda: delta.flatten_payload(as_payload(truth["main"][1])))
    full = clock("encode_full (msgpack pack)", lambda: delta.encode_full(flat))
    clock("sha256 of the full payload", lambda: hashlib.sha256(full).hexdigest())
    sample = full[: 64 << 20]
    t0 = time.perf_counter()
    objects.codec.compress(sample)
    log(f"phase d: {objects.codec.backend} compress "
        f"{len(sample) / (time.perf_counter() - t0) / 1e6:.1f} MB/s on 64 MiB of it")
    del full, sample
    raw = clock("read + decompress the root object",
                lambda: objects.get(repo.store.versions[1].object_key))
    clock("decode_full (msgpack unpack + tensors)", lambda: delta.decode_full(raw))
    del raw

    tracer = Tracer(enabled=True)
    old = set_tracer(tracer)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            repo.checkout("main")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        set_tracer(old)
    spans: dict = {}
    for sp in tracer.spans():
        spans[sp.name] = spans.get(sp.name, 0.0) + sp.duration
    log(f"phase d: traced cold checkout of main {wall:.3f} s; spans (s): "
        + json.dumps({k: round(v, 6) for k, v in spans.items()}))
    busy: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy[e.name] = busy.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
    total = sum(busy.values())
    if total:
        log(f"phase d: device busy {total:.6f} s of {wall:.3f} s "
            f"(idle share {1 - total / wall:.6f})")
        for name, sec in sorted(busy.items(), key=lambda kv: -kv[1])[:8]:
            log(f"phase d:   device {sec:.6f} s  {name[:90]}")
    else:
        log("phase d: device busy time not measured (the profiler saw no device events)")


# -------------------------------------------------- (j) XOR delta, block hash
def drive_block_ops(truth: dict, counters: Counters, device: str = "cuda") -> None:
    """Phase (j): the XOR and hash ops on the main path's data.  For every
    leaf of phase (b)'s main tip and its parent, uploaded from host ground
    truth: the XOR delta of parent and tip applied to the parent must give
    the tip byte for byte; the tip's block hashes must equal the plain
    version's; every block the changed-block mask marks unchanged must hash
    alike in both versions."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.block_diff import changed_block_mask, hash_coefficients

    parent, tip = truth["main^"][1], truth["main"][1]
    check(sorted(parent) == sorted(tip), "phase j: parent and tip hold different leaves")
    coef = torch.from_numpy(hash_coefficients()).to(device)
    counters.zero()
    t0 = time.perf_counter()
    changed_total = 0
    for name in sorted(tip):
        pb, meta = ops.to_blocks(leaf_tensor(name, parent[name]).to(device))
        tb, _ = ops.to_blocks(leaf_tensor(name, tip[name]).to(device))
        d = ops.xor_encode(pb, tb)
        back = ops.from_blocks(ops.xor_apply(pb, d), meta)
        want = np.ascontiguousarray(tip[name]).reshape(-1).view(np.uint8)
        check(np.array_equal(back.cpu().reshape(-1).view(torch.uint8).numpy(), want),
              f"phase j: {name}: xor_apply(parent, xor_encode(parent, tip)) != tip")
        ht, hp = ops.block_hashes(tb), ops.block_hashes(pb)
        check(torch.equal(ht, ref.block_hash_ref(tb, coef)[:, 0]),
              f"phase j: {name}: block_hashes differ from the plain version")
        same = changed_block_mask(pb, tb)[:, 0] == 0
        check(torch.equal(ht[same], hp[same]),
              f"phase j: {name}: an unchanged block hashes differently")
        changed = int((~same).sum())
        changed_total += changed
        log(f"phase j: {name}: {tb.shape[0]} blocks, {changed} changed, "
            f"{int((d != 0).flatten(1).any(dim=1).sum())} with a nonzero XOR delta, "
            f"{int(torch.unique(ht).numel())} distinct hashes")
    sync(device)
    log(f"phase j: {len(tip)} leaves round-tripped through the XOR delta and "
        f"hashed in {time.perf_counter() - t0:.3f} s ({changed_total} changed blocks)")
    counters.read("phase j (XOR delta and block hashes)", ("xor_delta", "block_hash"))


# ------------------------------------------------- (e) segment kernel checks
# versions of the phase (f) graphs: cut from 100,000 (then from 66,000) to
# keep the whole run near half its time limit, since the plain step loops and
# the CPU solvers the card is held against grow with n and with n x rows; the
# layouts keep 16,384 rows (SOLVER_ROWS; phase (e) checks it)
SOLVER_N = 16_000
SOLVER_ROWS = (16_384, 32)  # the in-edge and out-edge layouts' (rows, width)
LMG_MOVES = 1 << 14  # LMG's candidate moves at n = 16,000 (15,945), bucketed
LMG_CANDIDATES = 1 << 20  # the 1-D edge cases' length


def same_bits(got, want, what: str) -> float:
    """Bit-for-bit equality (a float's sign of zero included; NaN == NaN,
    whatever its bits); returns the max abs error (0)."""
    import torch

    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: {got.dtype} {tuple(got.shape)} != {want.dtype} {tuple(want.shape)}")
    if got.dtype.is_floating_point:
        nan = torch.isnan(got)
        same = torch.equal(nan, torch.isnan(want)) and torch.equal(
            torch.where(nan, 0, got.view(torch.int32)),
            torch.where(nan, 0, want.view(torch.int32)))
        check(same, f"{what}: differs from its plain version")
        fin = torch.isfinite(got) & torch.isfinite(want)
        return float((got[fin].double() - want[fin].double()).abs().max()) if fin.any() else 0.0
    check(torch.equal(got, want), f"{what}: differs from its plain version")
    return 0.0


def padded_rows_like(g, rows: int, width: int, dev):
    """A (rows, width) f32 matrix like the SSSP relaxation's: random costs in
    the first k columns of each row (k drawn 1..width), +inf padding, a few
    exact ties and all-+inf rows."""
    import torch

    x = torch.rand((rows, width), device=dev, generator=g) * 1e6
    fill = torch.randint(1, width + 1, (rows, 1), device=dev, generator=g)
    cols = torch.arange(width, device=dev)[None, :]
    x = torch.where(cols < fill, x, torch.inf)
    x[::97] = torch.inf                        # all-+inf rows
    if width > 3:
        x[5::101, 3] = x[5::101, 1]            # ties (first index must win)
    return x.contiguous()


def with_signed_zeros(x):
    """``x`` with rows 10-14 holding both zeros in several orders (XLA's min
    gives -0.0 in each; the argmin takes the first zero) and row 15 -inf."""
    w = x.shape[1]
    x[10:16] = 1.0
    x[10, :] = 0.0
    x[10, w - 1] = -0.0                        # -0 last, behind +0s
    x[11, :] = 0.0
    x[11, 0] = -0.0                            # -0 first
    x[12, ::2] = -0.0
    x[12, 1::2] = 0.0                          # alternating
    x[13, w // 2] = 0.0
    x[13, w - 1] = -0.0                        # +0, then -0 in another lane
    x[14, w - 1] = -0.0                        # a lone -0
    x[15, w // 3] = -float("inf")
    return x


def at_offset(x, elems: int = 1):
    """A contiguous copy of ``x`` whose data starts ``elems`` floats past an
    allocation's start (not 16-byte aligned for elems 1-3)."""
    import torch

    buf = torch.empty(x.numel() + elems, dtype=x.dtype, device=x.device)
    view = buf[elems:].view(x.shape)
    view.copy_(x)
    return view


def segment_checks(dev) -> list:
    """Phase (e): each solver kernel against its plain version at the main
    path's shapes and in edge cases, bit for bit, and timed."""
    import torch
    from torch.autograd import DeviceType

    from repro_torch import kernels
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_ops import (
        min_argmin_1d,
        segment_argmin_rows,
        segment_min_rows,
    )

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    nvp, width = SOLVER_ROWS
    results = []
    floor_ms = cuda_ms(lambda: kernels.launch("segment_launch_floor", dev))

    # per-row reductions: the in-edge matrix, then edge cases
    x = padded_rows_like(g, nvp, width, dev)
    err_min = same_bits(segment_min_rows(x), ref.segment_min_rows_ref(x), "segment_min_rows")
    err_arg = same_bits(segment_argmin_rows(x), ref.segment_argmin_rows_ref(x), "segment_argmin_rows")
    edge = padded_rows_like(g, 300, 37, dev)
    edge[7, 5] = torch.nan
    edge[8, [2, 30]] = torch.nan                   # two NaNs: the first wins
    edge[9, :] = 1.5                               # a row of ties
    with_signed_zeros(edge)
    cases = {
        "width 37, NaN, ties, all-inf, signed zeros": edge,
        "width 19": padded_rows_like(g, 1000, 19, dev),
        "width 1": padded_rows_like(g, 64, 1, dev),
        "one row": padded_rows_like(g, 1, 32, dev),
        "width 200": padded_rows_like(g, 33, 200, dev),
        "rows 5,003 x 32 at an odd offset": at_offset(padded_rows_like(g, 5003, 32, dev)),
        "width 8 at an odd offset": at_offset(padded_rows_like(g, 300, 8, dev), 3),
    }
    for w in (8, 24, 32, 40):
        cases[f"width {w}, signed zeros"] = with_signed_zeros(padded_rows_like(g, 1001, w, dev))
    for label, c in cases.items():
        same_bits(segment_min_rows(c), ref.segment_min_rows_ref(c), f"segment_min_rows ({label})")
        same_bits(segment_argmin_rows(c), ref.segment_argmin_rows_ref(c), f"segment_argmin_rows ({label})")
    check(int(segment_argmin_rows(edge)[8]) == 2, "segment_argmin_rows: first NaN must win")
    check(bool(torch.isnan(segment_min_rows(edge)[7])), "segment_min_rows: NaN must propagate")
    for w, c in ((37, edge), (8, cases["width 8, signed zeros"])):
        m = segment_min_rows(c)[10:15]
        check(bool((m == 0).all() and torch.signbit(m).all()),
              f"segment_min_rows: width {w}: a zero minimum must be -0.0 where the row holds one")
        check(segment_argmin_rows(c)[10:15].tolist() == [0, 0, 0, w // 2, w - 1],
              f"segment_argmin_rows: width {w}: the first zero must win")
    log(f"phase e: segment rows: {len(cases) + 1} cases bit-identical to the plain versions")
    row_bytes = nvp * width * 4 + nvp * 4
    results.append({
        "name": "segment_min_rows", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_kernels.cu",
        "replaces": "src/repro/kernels/segment_ops.py:62",
        "max_abs_err": err_min,
        "ms": cuda_ms(lambda: segment_min_rows(x)),
        "call_ms": host_call_ms(lambda: segment_min_rows(x)),
        "plain_ms": cuda_ms(lambda: ref.segment_min_rows_ref(x)),
        "bound_ms": bound_ms(row_bytes), "bound_by": "bytes",
        "library_ms": cuda_ms(lambda: torch.amin(x, 1)),
    })
    results.append({
        "name": "segment_argmin_rows", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_kernels.cu",
        "replaces": "src/repro/kernels/segment_ops.py:62",
        "max_abs_err": err_arg,
        "ms": cuda_ms(lambda: segment_argmin_rows(x)),
        "call_ms": host_call_ms(lambda: segment_argmin_rows(x)),
        "plain_ms": cuda_ms(lambda: ref.segment_argmin_rows_ref(x)),
        "bound_ms": bound_ms(row_bytes), "bound_by": "bytes",
        "library_ms": cuda_ms(lambda: torch.argmin(x, 1)),
    })
    del x, cases, edge

    # global (min, first argmin): an LMG candidate vector (-rho: mostly
    # +1 for infeasible candidates, a few scored) and a Prim/MP key
    # (+inf for tree vertices); then edge cases
    def both(v, what):
        gv, gi = min_argmin_1d(v)
        wv, wi = ref.min_argmin_1d_ref(v)
        same_bits(gi, wi, f"min_argmin_1d index ({what})")
        return same_bits(gv, wv, f"min_argmin_1d value ({what})")

    def scored_ones(n):
        """n ones, 4,096 of them scored below zero, three tied at the min."""
        v = torch.ones(n, device=dev)
        scored = torch.randint(0, n, (4096,), device=dev, generator=g)
        v[scored] = -torch.rand(4096, device=dev, generator=g) * 10
        v[scored[:3]] = v.min() - 1
        return v

    cand = scored_ones(LMG_MOVES)                  # the main path's LMG candidates
    wide = scored_ones(LMG_CANDIDATES)             # the edge cases' 2**20 (+ 3)
    key = torch.rand(nvp, device=dev, generator=g) * 1e6
    key[torch.rand(nvp, device=dev, generator=g) < 0.6] = torch.inf
    err_1d = max(both(cand, f"LMG candidates, n = {LMG_MOVES}"), both(key, "Prim/MP key"))
    both(wide, "n = 2**20")
    nan_v = key.clone()
    nan_v[[7_777, 9_999]] = torch.nan
    plus3 = torch.cat([wide, torch.ones(3, device=dev)])
    tail_min, head_min = plus3.clone(), plus3.clone()
    tail_min[-2:] = wide.min() - 2                 # the least two in the scalar tail
    zeros = torch.ones(1 << 16, device=dev)
    zeros[[40_001, 50_000]] = -0.0
    zeros[[40_000, 60_000]] = 0.0                  # +0 first: the value is +0.0
    neg_zeros = zeros.clone()
    neg_zeros[40_000] = -0.0                       # -0 first: the value is -0.0
    cases = {
        "NaN": nan_v,
        "all +inf": torch.full((nvp,), torch.inf, device=dev),
        "n = 2**20 + 3": plus3,
        "n = 2**20 + 3, min in the tail": tail_min,
        "n = 1_000_003": torch.rand(1_000_003, device=dev, generator=g),
        "n = 1": torch.rand(1, device=dev, generator=g),
        "n = 129, min last": torch.cat([torch.ones(128, device=dev),
                                        torch.zeros(1, device=dev)]),
        "all ties": torch.full((5000,), 2.0, device=dev),
        "signed zeros, +0 first": zeros,
        "signed zeros, -0 first": neg_zeros,
        "-inf": torch.cat([key, torch.tensor([-float("inf")] * 2, device=dev)]),
    }
    for k in (1, 2, 3):                            # contiguous views off 16-byte alignment
        cases[f"LMG candidates from element {k}"] = cand.view(-1)[k:]
        head_min[k] = wide.min() - 3               # the least in the scalar head
        cases[f"n = 2**20 + 3 from element {k}, min in the head"] = head_min.view(-1)[k:]
    for label, v in cases.items():
        both(v, label)
    check(int(min_argmin_1d(nan_v)[1]) == 7_777, "min_argmin_1d: first NaN must win")
    check(int(min_argmin_1d(torch.full((nvp,), torch.inf, device=dev))[1]) == 0,
          "min_argmin_1d: all +inf must give index 0")
    zv, zi = min_argmin_1d(zeros)
    check(int(zi) == 40_000 and float(zv) == 0 and not bool(torch.signbit(zv)),
          "min_argmin_1d: the first zero must win, with its own sign")
    zv, zi = min_argmin_1d(neg_zeros)
    check(int(zi) == 40_000 and float(zv) == 0 and bool(torch.signbit(zv)),
          "min_argmin_1d: the first zero must win, with its own sign")
    check(int(min_argmin_1d(tail_min)[1]) == LMG_CANDIDATES + 1,
          "min_argmin_1d: the least element of the scalar tail must win")

    # two streams at once: each keeps its own workspace and ticket
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    inputs = [cand, plus3]
    outs = [[], []]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(dev))
    for _ in range(50):
        for k, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[k].append(min_argmin_1d(inputs[k]))
    torch.cuda.synchronize()
    for k, v in enumerate(inputs):
        wv, wi = ref.min_argmin_1d_ref(v)
        for gv, gi in outs[k]:
            same_bits(gi, wi, f"min_argmin_1d index (stream {k})")
            same_bits(gv, wv, f"min_argmin_1d value (stream {k})")
    log(f"phase e: min_argmin_1d: {len(cases) + 3} cases and 2 x 50 calls on two "
        f"streams at once bit-identical to the plain version")

    # one kernel launch a call, nothing else (the workspace exists already)
    calls = 20
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            min_argmin_1d(cand)
        torch.cuda.synchronize()
    launched = sum(1 for e in prof.events()
                   if e.device_type != DeviceType.CUDA and e.name == "cudaLaunchKernel")
    on_device = sum(1 for e in prof.events()
                    if e.device_type == DeviceType.CUDA and "argmin_1d" in e.name)
    log(f"phase e: traced {calls} min_argmin_1d calls: {launched} cudaLaunchKernel, "
        f"{on_device} argmin_1d kernels on the device")
    check(launched == calls, f"min_argmin_1d: {launched} launches traced in {calls} calls")

    lmg_ms = cuda_ms(lambda: min_argmin_1d(cand))
    key_ms = cuda_ms(lambda: min_argmin_1d(key))
    results.append({
        "name": "min_argmin_1d", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_kernels.cu",
        "replaces": "src/repro/kernels/segment_ops.py:62",
        "max_abs_err": err_1d,
        "ms": lmg_ms,
        "call_ms": host_call_ms(lambda: min_argmin_1d(cand)),
        "plain_ms": cuda_ms(lambda: ref.min_argmin_1d_ref(cand)),
        "bound_ms": bound_ms(LMG_MOVES * 4 + 8), "bound_by": "bytes",
        "library_ms": cuda_ms(lambda: torch.min(cand, 0)),
        "shapes": f"LMG candidates ({LMG_MOVES},); the Prim/MP key ({nvp},): "
                  f"[{key_ms:.6f} ms, bound {bound_ms(nvp * 4 + 8):.9f} ms, torch.min "
                  f"{cuda_ms(lambda: torch.min(key, 0)):.6f} ms]",
    })

    del cand, wide, key, cases, inputs, outs, plus3, tail_min, head_min, nan_v, zeros, neg_zeros
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for r in results:
        r["launch_floor_ms"] = floor_ms
        log(f"kernel {r['name']}: max_abs_err {r['max_abs_err']} ms {r['ms']:.6f} "
            f"plain_ms {r['plain_ms']:.6f} bound_ms {r['bound_ms']:.9f} "
            f"library_ms {r['library_ms']} call_ms {r['call_ms']:.6f} "
            f"launch_floor_ms {floor_ms:.6f}" + (f" {r['shapes']}" if "shapes" in r else ""))
    return results + loop_checks(dev)


def loop_instance(rng, n: int, deg: int, *, ties=False, mirror=False, unreachable=0,
                  nan_roots=0, hub=0):
    """Edge arrays of ``n`` versions for the loop checks: a materialization
    edge from the root to each version but the last ``unreachable`` (which
    no edge reaches), ``deg`` random out-edges a version (duplicates and
    self-loops left to ``EdgeArrays``: it dedups, so a row lists distinct
    ids), ``hub`` more out of version 1.  ``ties`` draws every cost from a
    few integers, ``mirror`` adds each edge's reverse, ``nan_roots`` makes
    the first root edges' storage cost NaN (and their recreation cost 1)."""
    from repro_torch.core.edge_arrays import EdgeArrays

    reach = n - unreachable
    src = np.repeat(np.arange(1, n + 1), deg)
    dst = rng.integers(1, reach + 1, n * deg)
    if hub:
        src = np.concatenate([src, np.ones(hub, np.int64)])
        dst = np.concatenate([dst, rng.choice(reach, hub, replace=False) + 1])
    if mirror:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    if ties:
        delta = rng.integers(1, 4, src.size).astype(np.float64)
        phi = rng.integers(1, 4, src.size).astype(np.float64)
        rdelta = rng.integers(40, 43, reach).astype(np.float64)
        rphi = rng.integers(40, 43, reach).astype(np.float64)
    else:
        delta = rng.uniform(1, 1000, src.size)
        phi = delta * rng.uniform(0.2, 5, src.size)
        rdelta = rng.uniform(5e3, 1e4, reach)
        rphi = rdelta * rng.uniform(0.2, 5, reach)
    rdelta[:nan_roots] = np.nan
    rphi[:nan_roots] = 1.0  # under any theta, so MP's key is NaN there too
    return EdgeArrays.from_edges(
        n, np.concatenate([np.zeros(reach, np.int64), src]),
        np.concatenate([np.arange(1, reach + 1), dst]),
        np.concatenate([rdelta, delta]), np.concatenate([rphi, phi]))


def loop_checks(dev) -> list:
    """Phase (e), the solver loops: ``prim_loop`` and ``mp_loop`` against
    their plain versions on the card, bit for bit in every state array
    (Prim's best, bp, in_tree; MP's l, d, p, in_tree; the first nvp entries,
    as the JAX package returns them: the plain version's masked scatters
    write the trash entry nvp + 1, the kernels skip it), on phase (f)'s graphs
    at n = 2,000 and 16,000 and in edge cases; each timed at n = 16,000
    beside its plain version, its bytes bound and the latency floor (the
    same steps of one block barrier and one dependent L2 load each,
    ``segment_loop_floor``)."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import OptimizeSpec, optimize
    from repro_torch.core.solvers import torch_backend as tb
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_ops import mp_loop, prim_loop

    def prim_run(ea, steps):
        """(name, kernel, plain, initial state, state names, row shape)."""
        pd, pw, *st = tb.prim_state(ea, dev)
        return ("prim_loop", lambda x: prim_loop(pd, pw, *x, steps),
                lambda x: ref.prim_loop_ref(pd, pw, *x, steps), st,
                ("best", "bp", "in_tree"), tuple(pd.shape))

    def mp_run(ea, theta, steps):
        pd, pdelta, pphi, bound, *st = tb.mp_state(ea, theta, dev)
        return ("mp_loop", lambda x: mp_loop(pd, pdelta, pphi, bound, *x, steps),
                lambda x: ref.mp_loop_ref(pd, pdelta, pphi, bound, *x, steps), st,
                ("l", "d", "p", "in_tree"), tuple(pd.shape))

    def hold(label, ea, theta, steps=None):
        """Both loops on one instance: the kernel against the plain version."""
        out = {}
        t0 = time.perf_counter()
        steps = ea.n if steps is None else steps
        for name, kern, plain, init, names, shape in (prim_run(ea, steps),
                                                      mp_run(ea, theta, steps)):
            got, want = [t.clone() for t in init], [t.clone() for t in init]
            kern(got)
            plain(want)
            for nm, a, b in zip(names, got, want):  # entries nvp, nvp + 1: padding, trash
                same_bits(a[:shape[0]], b[:shape[0]], f"{name} {nm} ({label})")
            out[name] = int(got[-1].sum()) - 1  # vertices the loop put in the tree
        log(f"phase e: loops ({label}): nvp {shape[0]}, width {shape[1]}, "
            f"{steps} steps; vertices put in the tree "
            f"{json.dumps(out)}; bit-identical to the plain versions, in "
            f"{time.perf_counter() - t0:.3f} s with the layouts")

    def theta_of(g):
        return optimize(g, OptimizeSpec.problem(2, backend="numpy")).solution.max_recreation() * 1.5

    rng = np.random.default_rng(SEED + 3)
    gu, gd = solver_graph(2_000, False), solver_graph(2_000, True)
    hold("phase f's graphs, n = 2,000", gu.arrays(), theta_of(gd))
    hold("phase f's graphs, n = 2,000, MP undirected", gu.arrays(), theta_of(gu))
    theta = 1.2 * 3 * 7.5e3  # about the median root phi, so theta binds
    cases = {
        "ties": (loop_instance(rng, 1500, 12, ties=True, mirror=True), 45.0),
        "NaN keys": (loop_instance(rng, 1500, 12, nan_roots=3), theta),
        "unreachable versions": (loop_instance(rng, 1500, 12, unreachable=200), theta),
        "width 40": (loop_instance(rng, 1500, 37, mirror=False), theta),
        "width > 1,024": (loop_instance(rng, 1500, 6, hub=1100, mirror=True), theta),
        "a single vertex": (loop_instance(rng, 1, 1), theta),
    }
    for label, (ea, th) in cases.items():
        hold(label, ea, th)
    big = loop_instance(rng, (1 << 20) + 1, 8)
    check(tb.padded_out_rows(big)[0].ids.shape == (1 << 21, 8), "phase e: nvp 2**21 layout")
    hold("nvp = 2**21, width 8", big, theta, steps=48)
    del big

    # the main path's shape: phase (f)'s graphs at n = 16,000, timed
    gu, gd = solver_graph(SOLVER_N, False), solver_graph(SOLVER_N, True)
    cycle = torch.randperm(1 << 17, device=dev, dtype=torch.int64)
    nxt = torch.empty(1 << 17, dtype=torch.int32, device=dev)
    nxt[cycle] = torch.roll(cycle, -1).to(torch.int32)
    end = torch.empty(1, dtype=torch.int32, device=dev)
    results = []
    for name, kern, plain, init, names, shape in (
            prim_run(gu.arrays(), SOLVER_N), mp_run(gd.arrays(), theta_of(gd), SOLVER_N)):
        work = [t.clone() for t in init]

        def fresh(fn):
            def call():
                for w, t in zip(work, init):
                    w.copy_(t)
                fn(work)
            return call

        want = [t.clone() for t in init]
        plain_ms = cuda_ms(lambda: plain(want), iters=1, warmup=0)
        ms = cuda_ms(fresh(kern), iters=3, warmup=1)
        err = max(same_bits(a[:shape[0]], b[:shape[0]], f"{name} {nm} (n = {SOLVER_N})")
                  for nm, a, b in zip(names, work, want))
        steps = int(work[-1].sum()) - 1  # steps that selected a vertex
        nvp, width = shape
        check(shape == SOLVER_ROWS, f"phase e: {name}'s layout at n = {SOLVER_N} is {shape}, "
              f"not SOLVER_ROWS {SOLVER_ROWS}")
        row = width * (4 + 4 * (len(names) - 2))   # ids and the costs a step reads
        state = (nvp + 2) * sum(t.element_size() for t in init)
        nbytes = steps * row + 2 * state           # the state read and written once
        floor_ms = cuda_ms(lambda: kernels.launch(
            "segment_loop_floor", dev, nxt.data_ptr(), end.data_ptr(), steps), iters=3, warmup=1)
        results.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segment_kernels.cu",
            "replaces": "src/repro/kernels/segment_ops.py:62",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms(nbytes), "bound_by": "bytes", "library_ms": None,
        })
        log(f"kernel {name}: n = {SOLVER_N} ({nvp} x {width} rows, {steps} steps): "
            f"max_abs_err {err} ms {ms:.6f} plain_ms {plain_ms:.6f} bound_ms (bytes, "
            f"{nbytes} B) {bound_ms(nbytes):.9f} latency floor ms {floor_ms:.6f} "
            f"({floor_ms / steps * 1e3:.4f} us a step; kernel {ms / steps * 1e3:.4f} us "
            f"a step); binding: {'latency' if floor_ms > bound_ms(nbytes) else 'bytes'}")
    del work, want, nxt
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------ (f) solvers
def solver_graph(n: int, directed: bool):
    """The solver-scale sweep's DC-like instance (edges ~20-30 a version)."""
    from repro_torch.core import WorkloadSpec, generate_flat

    return generate_flat(WorkloadSpec(
        commits=n, branch_interval=3, branch_prob=0.7, branch_limit=4,
        branch_length=4, reveal_hops=3, seed=SEED % 1000, directed=directed,
    )).graph


def drive_solvers(counters: "Counters") -> dict:
    """Phase (f): the four device solvers through ``optimize`` on the card,
    the CPU (plain versions) and numpy; returns per-solver timings."""
    import torch

    from repro_torch.core import OptimizeSpec, optimize

    def specs(gd, gu):
        """(label, graph, spec factory taking the backend) per solver; the
        bounds come from numpy's trees, so every backend solves one problem."""
        base = optimize(gd, OptimizeSpec.problem(1, backend="numpy")).solution
        spt = optimize(gd, OptimizeSpec.problem(2, backend="numpy")).solution
        beta = base.storage_cost() * 1.05
        theta = spt.max_recreation() * 1.5
        return [
            ("spt", gd, lambda b: OptimizeSpec.problem(2, backend=b)),
            ("prim", gu, lambda b: OptimizeSpec.problem(1, backend=b)),
            ("lmg", gd, lambda b: OptimizeSpec.problem(3, beta=beta, backend=b)),
            ("mp", gd, lambda b: OptimizeSpec.problem(6, theta=theta, backend=b)),
        ]

    def run(g, spec, device):
        t0 = time.perf_counter()
        res = optimize(g, spec, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    t0 = time.perf_counter()
    gd, gu = solver_graph(SOLVER_N, True), solver_graph(SOLVER_N, False)
    gd.arrays(), gu.arrays()  # each graph's cached edge view, before any backend is timed
    log(f"phase f: graphs n={SOLVER_N}: directed {gd.n_edges} edges, undirected "
        f"{gu.n_edges} edges, made in {time.perf_counter() - t0:.3f} s")
    out = {}
    for label, g, make in specs(gd, gu):
        counters.zero()
        cuda, cuda_s = run(g, make("torch"), "cuda")
        launches = counters.read(f"phase f ({label}, cuda)", SOLVER_NEEDS[label])
        check(cuda.backend_used == "torch", f"phase f {label}: backend_used {cuda.backend_used}")
        cpu, cpu_s = run(g, make("torch"), "cpu")
        numpy_res, numpy_s = run(g, make("numpy"), "cpu")
        check(cuda.solution.parent == cpu.solution.parent,
              f"phase f {label}: the card's tree differs from the CPU torch tree")
        differ = sum(1 for v, p in cuda.solution.parent.items()
                     if numpy_res.solution.parent[v] != p)
        if label in SOLVER_LOOP:
            check(launches[SOLVER_LOOP[label]] == 1 and launches["min_argmin_1d"] == 0,
                  f"phase f {label}: {SOLVER_LOOP[label]} launched "
                  f"{launches[SOLVER_LOOP[label]]} times and min_argmin_1d "
                  f"{launches['min_argmin_1d']} times in one solve, not once and never")
            log(f"phase f: {label}: the card {'below' if cuda_s < numpy_s else 'NOT below'} "
                f"numpy ({cuda_s:.3f} s against {numpy_s:.3f} s)")
        out[label] = {"cuda_s": cuda_s, "cpu_s": cpu_s, "numpy_s": numpy_s,
                      "launches": launches}
        log(f"phase f: {label}: backend_used cuda={cuda.backend_used} cpu={cpu.backend_used} "
            f"numpy={numpy_res.backend_used}; wall cuda {cuda_s:.3f} s, cpu {cpu_s:.3f} s, "
            f"numpy {numpy_s:.3f} s; cuda tree == cpu tree; parents differing from "
            f"numpy {differ} of {g.n}; objective {cuda.spec.objective.metric} torch "
            f"{cuda.objective_value!r} numpy {numpy_res.objective_value!r}")
    return out


def solver_trace(sizes=(500, 2_000)) -> None:
    """Prim and MP on the card under torch.profiler at each of ``sizes``
    versions: the device's busy share, the host synchronisations and the
    kernel launches the run made, which must not grow with the number of
    steps (each loop is one launch and never syncs)."""
    import torch
    from torch.autograd import DeviceType

    from repro_torch.core import OptimizeSpec, optimize

    syncs = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    launched = {}
    for n in sizes:
        gu, gd = solver_graph(n, False), solver_graph(n, True)
        theta = optimize(gd, OptimizeSpec.problem(2, backend="numpy")).solution.max_recreation() * 1.5
        for label, g, spec in (("prim", gu, OptimizeSpec.problem(1)),
                               ("mp", gd, OptimizeSpec.problem(6, theta=theta))):
            optimize(g, spec, device="cuda")  # warm
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                optimize(g, spec, device="cuda")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            busy, counts, device = 0.0, {}, {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    busy += e.time_range.elapsed_us() / 1e6
                    device[e.name[:40]] = device.get(e.name[:40], 0) + 1
                elif e.name in syncs or e.name == "cudaLaunchKernel":
                    counts[e.name] = counts.get(e.name, 0) + 1
            n_sync = sum(v for k, v in counts.items() if k in syncs)
            share = (f"device busy {busy:.6f} s (idle share {1 - busy / wall:.6f})" if busy else
                     "device busy time not measured (the profiler recorded no device events)")
            log(f"phase f: traced {label} n={n} ({n} steps) in {wall:.3f} s: {share}; runtime "
                f"events {json.dumps(counts)}; device events {json.dumps(device)}")
            if counts.get("cudaLaunchKernel"):
                check(n_sync < 100, f"phase f: {label} synchronised {n_sync} times in {n} steps")
                launched.setdefault(label, []).append(counts["cudaLaunchKernel"])
            else:
                log(f"phase f: {label}: the trace holds no runtime API events; host "
                    f"synchronisations and launches not measured")
    for label, counts in launched.items():
        check(counts[-1] <= counts[0] + 10 and counts[-1] < 100,
              f"phase f: {label} launched {counts} kernels at n = {list(sizes)}: "
              f"the launches grow with the steps")


# which kernels each solver's card run must launch
SOLVER_NEEDS = {
    "spt": ("segment_min_rows", "segment_argmin_rows"),
    "prim": ("prim_loop",),
    "lmg": ("segment_min_rows", "segment_argmin_rows", "min_argmin_1d"),
    "mp": ("mp_loop",),
}
# the one kernel of a whole Prim / MP solve, launched once
SOLVER_LOOP = {"prim": "prim_loop", "mp": "mp_loop"}


# -------------------------------------------------------- (g) store repack
# name -> (dtype, shape): ~4 MiB per version, four dtypes
REPACK_LEAVES = {
    "table/f32": ("float32", (512, 1024)),     # 2 MiB
    "table/f16": ("float16", (256, 2048)),     # 1 MiB
    "emb/bf16": ("bfloat16", (256, 1024)),     # 512 KiB
    "tok/i8": ("int8", (524_288,)),            # 512 KiB
}
REPACK_VERSIONS = 64


def drive_repack(root: Path, counters: "Counters", device: str = "cuda") -> dict:
    """Phase (g): commit a branching history, repack it with Problem 3 and
    then Problem 6 on the card, and check every version out."""
    from repro_torch.core import OptimizeSpec
    from repro_torch.store import Repository

    rng = np.random.default_rng(SEED + 7)
    tree = {}
    for name, (dtype, shape) in REPACK_LEAVES.items():
        n = int(np.prod(shape))
        if dtype == "bfloat16":
            import torch

            f = torch.from_numpy(rng.standard_normal(n, dtype=np.float32))
            arr = f.to(torch.bfloat16).view(torch.uint16).numpy()
        elif dtype == "int8":
            arr = rng.integers(-128, 128, n, dtype=np.int8)
        else:
            arr = rng.standard_normal(n, dtype=np.float32).astype(dtype)
        tree[name] = arr.reshape(shape)

    def as_repack_payload(t):
        import torch

        payload: dict = {}
        for name, arr in t.items():
            x = torch.from_numpy(arr)
            if REPACK_LEAVES[name][0] == "bfloat16":
                x = x.view(torch.bfloat16)
            group, leaf = name.split("/")
            payload.setdefault(group, {})[leaf] = x
        return payload

    budget = (REPACK_VERSIONS + 8) * sum(a.nbytes for a in tree.values())
    repo = Repository(root, device=device, cache_budget_bytes=budget)
    truth = {}
    counters.zero()
    t0 = time.perf_counter()
    truth[repo.commit(as_repack_payload(tree), message="root")] = tree
    # a branching history: every 8th commit forks a branch off a random
    # earlier version; commits alternate which two leaves they edit
    tips = {"main": tree}
    for i in range(1, REPACK_VERSIONS):
        if i % 8 == 0:
            base_vid = int(rng.integers(1, i + 1))
            name = f"b{i}"
            repo.branch(name, at=base_vid)
            tips[name] = truth[base_vid]
        branch = list(tips)[-1] if i % 8 else name
        parent = dict(tips[branch])
        for leaf in list(REPACK_LEAVES)[(i % 2) * 2:(i % 2) * 2 + 2]:
            parent[leaf] = edit_blocks(rng, parent[leaf])
        vid = repo.commit(as_repack_payload(parent), branch=branch, message=f"{branch} {i}")
        truth[vid] = parent
        tips[branch] = parent
    commit_s = time.perf_counter() - t0
    log(f"phase g: {len(truth)} versions of "
        f"{sum(a.nbytes for a in tree.values()) / 2**20:.2f} MiB committed in "
        f"{commit_s:.3f} s over {len(tips)} branches; stored "
        f"{repo.store.storage_bytes()} bytes")

    # the repack's own measurement: every Δ around the derivation DAG, each a
    # delta encode (changed_block_mask) of two checkouts (chain_delta_apply)
    t0 = time.perf_counter()
    g, _ = repo.store.build_cost_graph()
    log(f"phase g: build_cost_graph measured {repo.store.last_measured_edges} "
        f"edges in {time.perf_counter() - t0:.3f} s")
    counters.read("phase g (commits + build_cost_graph)", ("changed_block_mask",))

    from repro_torch.core import minimum_storage_tree

    out = {}
    for problem in (3, 6):
        if problem == 3:
            beta = minimum_storage_tree(g, backend="numpy").storage_cost() * 1.05
            spec = OptimizeSpec.problem(3, beta=beta)
        else:
            spec = OptimizeSpec.problem(
                6, theta=1.5 * max(repo.store.recreation_cost(v) for v in truth))
        counters.zero()
        t0 = time.perf_counter()
        res = repo.repack(spec)
        wall = time.perf_counter() - t0
        launches = counters.read(
            f"phase g (repack, Problem {problem})",
            SOLVER_NEEDS["lmg" if problem == 3 else "mp"],
        )
        check(res["optimize"]["backend"] == "torch",
              f"phase g: Problem {problem} ran on {res['optimize']['backend']}")
        log(f"phase g: repack Problem {problem} in {wall:.3f} s: storage_bytes "
            f"{res['before']['storage_bytes']} -> {res['after']['storage_bytes']}, "
            f"max_recreation_s {res['before']['max_recreation_s']:.6f} -> "
            f"{res['after']['max_recreation_s']:.6f}, gc_freed_bytes "
            f"{res['gc_freed_bytes']}, backend_used {res['optimize']['backend']}, "
            f"solver wall {res['optimize']['wall_time_s']} s, measured edges "
            f"{repo.store.last_measured_edges}")
        out[problem] = {"wall_s": wall, "launches": launches, **res}
    repo.close()

    repo = Repository(root, device=device, cache_budget_bytes=0)
    t0 = time.perf_counter()
    for vid, want in truth.items():
        got = repo.store.checkout(vid)
        same_tree(got, want, f"repacked v{vid}")
    log(f"phase g: all {len(truth)} versions checked out byte for byte after "
        f"both repacks in {time.perf_counter() - t0:.3f} s")
    repo.close()
    return out


# ------------------------------------------------ (i) the dataset service
# phase (b)'s six leaves at their dtypes, each cut to 1/64 of its rows:
# ~8 MiB a version (see drive_service for why not larger)
SERVICE_LEAVES = {name: (dtype, (shape[0] // 64,) + shape[1:])
                  for name, (dtype, shape) in LEAVES.items()}
SERVICE_VERSIONS = 64
SERVICE_BRANCH_EVERY = 4     # every 4th commit forks a branch
SERVICE_CACHE_VERSIONS = 8   # cache budget, in versions
SERVICE_REQUESTS = 300       # open-loop requests
SERVICE_WRITE_SHARE = 0.08   # of them commits
SERVICE_ZIPF_S = 1.1         # as benchmarks/serving_checkout.py
SERVICE_WARMUP = 64          # closed-loop warm-up requests ...
SERVICE_CLIENTS = 8          # ... from this many clients


def leaf_digest(t) -> tuple:
    """(shape, itemsize, sha256) of a leaf: a host tensor or a host array."""
    import hashlib

    import torch

    if isinstance(t, torch.Tensor):
        raw = t.contiguous().reshape(-1).view(torch.uint8).numpy()
        return tuple(t.shape), t.element_size(), hashlib.sha256(raw).hexdigest()
    raw = np.ascontiguousarray(t).reshape(-1).view(np.uint8)
    return t.shape, t.itemsize, hashlib.sha256(raw).hexdigest()


def zipf_reads(vids: list, n: int, rng: np.random.RandomState) -> list:
    """Zipfian reads (benchmarks/serving_checkout.py:zipf_requests): rank r
    of a seeded permutation of ``vids`` gets p proportional to 1 / r**s."""
    ranked = rng.permutation(vids)
    p = 1.0 / np.arange(1, len(ranked) + 1) ** SERVICE_ZIPF_S
    return [int(v) for v in rng.choice(ranked, size=n, p=p / p.sum())]


def drive_service(root: Path, counters: Counters, device: str = "cuda") -> dict:
    """Phase (i): the asynchronous dataset service over a store on the card.

    A ``Repository`` of 64 versions (phase (b)'s leaves cut to 1/64, a
    branch every 4 commits, a cache of 8 versions) is served through
    ``repo.serve(readers=4, batch_window_s=0.002, fsck_interval_s=5,
    fsck_sample=4)`` under an enabled tracer.  A closed-loop warm-up (8
    clients) measures the throughput; then 300 open-loop requests arrive as
    a Poisson process at half that rate, zipfian reads (s = 1.1) over the
    64 versions and 8% commits.  Midway, with the first half's requests
    still in flight, ``svc.repack(OptimizeSpec.problem(6, theta))`` takes
    the writer side (the schedule pauses while it runs); the second half's
    commits go to a branch forked at a version the repack stored whole, so
    the recorded bound theta holds for them.  A final ``svc.fsck()`` must
    report no gating finding, every served tree must equal host ground
    truth (a sha256 per leaf), and every committed version is checked out
    at the end.  The cut to 1/64 (not 1/8): ``build_cost_graph``, inside the
    repack, zlib-compresses every version's full payload on the host, which
    runs at ~20 MB/s on the card's machine (phase d).
    """
    import asyncio

    import torch

    from repro_torch import obs
    from repro_torch.core import OptimizeSpec
    from repro_torch.store import Repository

    rng = np.random.default_rng(SEED + 9)
    tree = make_dataset(rng, SERVICE_LEAVES)
    version_bytes = sum(a.nbytes for a in tree.values())
    repo = Repository(root, device=device,
                      cache_budget_bytes=SERVICE_CACHE_VERSIONS * version_bytes)
    digests: dict = {}  # id(leaf) -> digest; every leaf hashed stays alive,
                        # and served trees share tensors (warm hits)

    def digest_of(t: dict) -> dict:
        out = {}
        for name, arr in t.items():
            if id(arr) not in digests:
                digests[id(arr)] = leaf_digest(arr)
            out[name] = digests[id(arr)]
        return out

    counters.zero()
    t0 = time.perf_counter()
    trees = {repo.commit(as_payload(tree), message="root"): tree}
    tips = {"main": tree}
    for i in range(1, SERVICE_VERSIONS):
        if i % SERVICE_BRANCH_EVERY == 0:
            branch = f"b{i}"
            base_vid = int(rng.integers(1, i + 1))
            repo.branch(branch, at=base_vid)
            tips[branch] = trees[base_vid]
        else:
            branch = list(tips)[-1]
        t = dict(tips[branch])
        for name in PAIRS[i % 2]:
            t[name] = edit_blocks(rng, t[name])
        trees[repo.commit(as_payload(t), branch=branch, message=f"{branch} {i}")] = t
        tips[branch] = t
    truth = {vid: digest_of(t) for vid, t in trees.items()}
    store = repo.store
    theta = 1.5 * max(store.recreation_cost(v) for v in store.versions)
    log(f"phase i: {len(trees)} versions of {version_bytes / 2**20:.2f} MiB committed in "
        f"{time.perf_counter() - t0:.3f} s over {len(tips)} branches; stored "
        f"{store.storage_bytes()} bytes; max recreation {theta / 1.5:.6f} s")

    # the workload, made up front: zipfian reads over the committed
    # versions, commit payloads continuing the main line's edits
    wrng = np.random.RandomState(SEED % 2**31)
    warm_reads = zipf_reads(sorted(trees), SERVICE_WARMUP, wrng)
    reads = zipf_reads(sorted(trees), SERVICE_REQUESTS, wrng)
    gaps = wrng.exponential(1.0, size=SERVICE_REQUESTS)  # scaled by the rate
    is_commit = wrng.rand(SERVICE_REQUESTS) < SERVICE_WRITE_SHARE
    payloads = []
    t = tips["main"]
    for _ in range(int(is_commit.sum())):
        t = dict(t)
        for name in PAIRS[len(payloads) % 2]:
            t[name] = edit_blocks(rng, t[name])
        payloads.append(t)
    half = SERVICE_REQUESTS // 2
    served = []      # (vid, tree) of every read
    latencies = []   # open-loop: completion - scheduled arrival
    committed = {}   # vid -> host tree

    async def run():
        loop = asyncio.get_running_loop()
        async with repo.serve(readers=4, batch_window_s=0.002,
                              fsck_interval_s=5, fsck_sample=4) as svc:
            # closed loop: SERVICE_CLIENTS clients, each request after the last
            async def client(vids):
                for v in vids:
                    served.append((v, await svc.checkout(v)))

            t0 = loop.time()
            await asyncio.gather(*(client(warm_reads[c::SERVICE_CLIENTS])
                                   for c in range(SERVICE_CLIENTS)))
            warm_qps = SERVICE_WARMUP / (loop.time() - t0)
            rate = warm_qps / 2
            log(f"phase i: closed-loop warm-up: {SERVICE_WARMUP} reads from "
                f"{SERVICE_CLIENTS} clients at {warm_qps:.3f} QPS; open loop at "
                f"{rate:.3f} QPS")

            async def fire(k: int, at: float, branch: str):
                if is_commit[k]:
                    body = payloads[int(is_commit[:k].sum())]
                    vid = await svc.commit(as_payload(body), branch=branch,
                                           message=f"service {k}")
                    committed[vid] = body
                else:
                    served.append((reads[k], await svc.checkout(reads[k])))
                latencies.append((bool(is_commit[k]), loop.time() - at))

            arrivals = np.cumsum(gaps) / rate
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            tasks = []
            with torch.profiler.profile(activities=acts) as prof:
                start = loop.time()
                shift = 0.0
                for k in range(SERVICE_REQUESTS):
                    if k == half:
                        # midway: repack while the first half is in flight
                        r0 = loop.time()
                        counters_before = {n: sum(f.launches for f in fns)
                                           for n, fns in counters.fns.items()}
                        res = await svc.repack(OptimizeSpec.problem(6, theta=theta))
                        repack_s = loop.time() - r0
                        await asyncio.gather(*tasks)
                        fresh = {n: sum(f.launches for f in fns) - counters_before[n]
                                 for n, fns in counters.fns.items()}
                        full = min((v for v, m in store.versions.items()
                                    if m.stored_base is None),
                                   key=store.recreation_cost)
                        repo.branch("ingest", at=full)
                        # the recorded bound must hold for what the second
                        # half appends: a chain of deltas off a whole version
                        room = store.recreation_cost(full) + int(is_commit[half:].sum()) * max(
                            m.phi for m in store.versions.values() if m.stored_base is not None)
                        check(room <= theta, f"phase i: the ingest chain may reach {room:.6f} s "
                              f"of recreation, above theta {theta:.6f} s")
                        shift += loop.time() - r0
                        log(f"phase i: repack (Problem 6, theta {theta:.6f} s) in "
                            f"{repack_s:.3f} s: storage_bytes "
                            f"{res['before']['storage_bytes']} -> "
                            f"{res['after']['storage_bytes']}, max_recreation_s "
                            f"{res['before']['max_recreation_s']:.6f} -> "
                            f"{res['after']['max_recreation_s']:.6f}, backend "
                            f"{res['optimize']['backend']}, launches {json.dumps(fresh)}; "
                            f"ingest forks at v{full}")
                        check(res["optimize"]["backend"] == "torch",
                              f"phase i: repack ran on {res['optimize']['backend']}")
                        check(fresh["mp_loop"] > 0, "phase i: the repack launched no MP kernel")
                    at = start + shift + arrivals[k]
                    delay = at - loop.time()
                    if delay > 0:
                        await asyncio.sleep(delay)
                    tasks.append(loop.create_task(
                        fire(k, at, "main" if k < half else "ingest")))
                await asyncio.gather(*tasks)  # each ends in host tensors
                makespan = loop.time() - start
            report = await svc.fsck()
            late = await svc.checkout_many(sorted(committed))
            return {"warm_qps": warm_qps, "rate": rate, "makespan": makespan,
                    "open_loop_s": makespan - shift, "prof": prof,
                    "report": report, "late": late, "stats": svc.stats()}

    with obs.tracing() as tracer:
        out = asyncio.run(run())
    stats, report = out["stats"], out["report"]

    fails = [f"v{vid}" for vid, got in served if digest_of(got) != truth[vid]]
    for (vid, body), got in zip(sorted(committed.items()), out["late"]):
        if digest_of(got) != digest_of(body):
            fails.append(f"committed v{vid}")
    check(not fails, f"phase i: served trees differ from ground truth: {fails[:10]}")
    check(not report.gating(), "phase i: the final fsck reports " +
          "; ".join(f.render() for f in report.gating()))
    reads_ms = sorted(s * 1e3 for w, s in latencies if not w)
    pct = lambda q: reads_ms[min(len(reads_ms) - 1, int(q / 100 * (len(reads_ms) - 1) + 0.5))]
    c = stats["counters"]
    summ = tracer.summary()

    def recon(span, track):
        tk = stats["tracks"][track]
        return summ[span]["total_s"] / (tk["mean_ms"] * tk["count"] / 1e3)

    path = root / "service_trace.json"
    obs.chrome_trace(tracer, path)
    problems = obs.validate_chrome_trace(path)
    check(not problems, f"phase i: the exported trace does not validate: {problems[:3]}")
    log(f"phase i: {SERVICE_REQUESTS} open-loop requests ({len(committed)} commits) in "
        f"{out['open_loop_s']:.3f} s of schedule ({SERVICE_REQUESTS / out['open_loop_s']:.3f} "
        f"QPS; makespan with the repack {out['makespan']:.3f} s); reads p50 {pct(50):.3f} ms "
        f"p99 {pct(99):.3f} ms; service tracks latency.checkout "
        f"{json.dumps(stats['tracks'].get('latency.checkout'))}")
    log(f"phase i: counters coalesced {c.get('checkout.coalesced', 0)} batches "
        f"{c.get('checkout.batches', 0)} batched_refs {c.get('checkout.batched_refs', 0)} "
        f"warm_hits {c.get('checkout.warm_hits', 0)} warm_misses "
        f"{c.get('checkout.warm_misses', 0)} fsck.sweeps {c.get('fsck.sweeps', 0)}; "
        f"store {json.dumps(stats['store'])}")
    log(f"phase i: tradeoff monitor last sample {json.dumps(stats['tradeoff']['latest'])}")
    log(f"phase i: span/track reconciliation queue_wait "
        f"{recon('svc.queue_wait', 'queue_wait'):.6f} decode {recon('svc.decode', 'decode'):.6f}; "
        f"trace of {len(tracer)} spans ({tracer.dropped} dropped) validates")
    log(f"phase i: final fsck: {report.render().splitlines()[0]}")
    log(f"phase i: served {len(served)} trees and {len(committed)} committed versions, "
        f"all equal to ground truth; open loop: {busy_share(out['prof'], out['makespan'])}")
    repo.close()
    counters.read("phase i (service)", ("chain_delta_apply", "changed_block_mask",
                                        "mp_loop"))
    return {"warm_qps": out["warm_qps"], "rate": out["rate"]}


# ------------------------------------------------- (h) dense-LM serving
TENSOR_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate (data sheet)
SERVE_ARCH = "minitron-4b"
SERVE_BATCH = 8
SERVE_PROMPTS = (2048, 1152, 1000)  # flash, flash (not a multiple of 512), gate
SERVE_NEW = 32
FLASH_TOL = 2e-2
# and at most this share of the row's max |want|: a non-causal row averages
# hundreds of keys, so its outputs are far under FLASH_TOL; a kernel that
# skipped one KV tile must land above the limit (``skipped_tile_err``)
FLASH_REL_TOL = 2e-2
# label, B, Sq, Sk, H, KV, hd, causal, softmax_scale, fused: unit-normal bf16
# inputs; fused takes q, k, v as strided views of one (B, S, H + 2 KV, hd)
# tensor, as a fused QKV projection would give them
FLASH_SHAPES = (
    ("serving", 8, 2048, 2048, 24, 8, 128, True, None, False),  # minitron-4b's prefill
    ("phi serving", 4, 2048, 2048, 32, 8, 128, True, None, False),  # phase (n)'s prefill
    ("S=1152", 8, 1152, 1152, 24, 8, 128, True, None, False),   # 128 | S, 512 does not
    ("g=1 hd=64", 2, 2048, 2048, 36, 36, 64, True, None, False),  # minicpm-2b's heads
    ("g=9", 2, 2048, 2048, 36, 4, 128, True, None, False),      # starcoder2-7b's heads
    ("g=9 B=8", 8, 2048, 2048, 36, 4, 128, True, None, False),
    ("causal=False", 2, 2048, 2048, 24, 8, 128, False, None, False),
    ("scale", 2, 1024, 1024, 24, 8, 128, True, 57 ** -0.5, False),
    ("S=128", 8, 128, 128, 24, 8, 128, True, None, False),      # one tile
    ("hd=32", 2, 512, 512, 4, 2, 32, True, None, False),        # the reduced configs' heads
    ("fused qkv", 8, 2048, 2048, 24, 8, 128, True, None, True),  # TMA through strides
    ("S=200", 2, 200, 200, 24, 8, 128, True, None, False),      # keys past a tile, called directly
    ("Sq=128 Sk=2048", 2, 128, 2048, 24, 8, 128, False, None, False),
    ("seamless encoder", 8, 1024, 1024, 16, 16, 64, False, None, False),  # phase (p)'s encoder
)
FLASH_TIMED = ("phi serving", "S=1152", "g=1 hd=64", "g=9", "g=9 B=8",
               "seamless encoder")  # logged beside SDPA


def flash_blocks(S: int) -> int:
    """The block size ``_full_attention`` passes for a sequence of S (and,
    for one that is not a multiple of 128, S itself: a direct call)."""
    return 512 if S % 512 == 0 else 128 if S % 128 == 0 else S


def skipped_tile_err(q, k, v, want, block_k: int, causal: bool, scale) -> tuple:
    """The max abs gap from ``want`` of two planted faults, computed by SDPA
    with an explicit mask on the row's inputs: (a kernel that skipped the
    first KV tile for every query with keys past it, one whose softmax
    scale is 5% off)."""
    import torch
    import torch.nn.functional as F

    Sq, Sk, g = q.shape[1], k.shape[1], q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt, vt = (t.transpose(1, 2).repeat_interleave(g, dim=1) for t in (k, v))
    i = torch.arange(Sq, device=q.device)[:, None]
    j = torch.arange(Sk, device=q.device)[None, :]
    keep = (j <= i) if causal else torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    s = scale if scale is not None else q.shape[-1] ** -0.5
    gaps = []
    for mask, sc in ((keep & ~((j < block_k) & ((i >= block_k) if causal else True)), s),
                     (keep, 1.05 * s)):
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=sc)
        gaps.append(float((out.transpose(1, 2).float() - want.float()).abs().max()))
        del out
    return tuple(gaps)


def flash_checks(dev) -> list:
    """Phase (h), kernel part: flash_attention against its plain version on
    the card at every shape of FLASH_SHAPES, bit-equal across two calls,
    timed at the serving shape beside its bound, the plain version and SDPA
    (the yardstick, never on the path), and at the FLASH_TIMED shapes beside
    SDPA and its bound (logged)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    result = None
    for label, B, Sq, Sk, H, KV, hd, causal, scale, fused in FLASH_SHAPES:
        if fused:
            assert Sq == Sk
            qkv = torch.randn((B, Sq, H + 2 * KV, hd), generator=g, device=dev).to(torch.bfloat16)
            q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
            check(not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous()),
                  "flash_attention fused qkv: the views are contiguous")
        else:
            q = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(torch.bfloat16)
            k = torch.randn((B, Sk, KV, hd), generator=g, device=dev).to(torch.bfloat16)
            v = torch.randn((B, Sk, KV, hd), generator=g, device=dev).to(torch.bfloat16)
        bq, bk = flash_blocks(Sq), flash_blocks(Sk)
        kw = dict(causal=causal, softmax_scale=scale)
        got = flash_attention(q, k, v, block_q=bq, block_k=bk, **kw)
        again = flash_attention(q, k, v, block_q=bq, block_k=bk, **kw)
        want = flash_attention_ref(q, k, v, block_k=bk, **kw)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        top = float(want.float().abs().max())
        limit = min(FLASH_TOL, FLASH_REL_TOL * top)
        same = torch.equal(got, again)
        faults = ""
        if Sk > bk:   # a second KV tile to keep when the first is skipped
            skipped, off = skipped_tile_err(q, k, v, want, bk, causal, scale)
            faults = (f"; planted faults: the first KV tile skipped max_abs_err {skipped} "
                      f"({skipped / top:.4f} of max |want|), softmax scale 5% off {off} "
                      f"({off / top:.4f})")
            check(skipped > limit, f"flash_attention {label}: a skipped KV tile lands at "
                                   f"{skipped}, within the limit {limit}")
        log(f"phase h: flash_attention {label} (B {B}, Sq {Sq}, Sk {Sk}, H {H}, KV {KV}, "
            f"hd {hd}, causal {causal}, scale {scale}, fused views {fused}): max_abs_err "
            f"{err} ({err / top:.4f} of max |want| {top}; limit {limit}), two calls bit-equal "
            f"{same}{faults}")
        check(err <= limit, f"flash_attention {label}: max_abs_err {err} > {limit} "
                            f"(min of {FLASH_TOL} and {FLASH_REL_TOL} of max |want| {top})")
        check(same, f"flash_attention {label}: two calls on the same inputs differ")
        if label != "serving" and label not in FLASH_TIMED:
            continue
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                      scale=scale, enable_gqa=True)
        lib_err = float((sdpa().transpose(1, 2).float() - got.float()).abs().max())
        flops = (4 * B * H * hd * Sq * (Sq + 1) // 2 if causal and Sq == Sk
                 else 4 * B * H * hd * Sq * Sk)
        nbytes = 2 * (2 * B * Sq * H * hd + 2 * B * Sk * KV * hd)
        t_ops, t_bytes = flops / TENSOR_FLOPS_PER_S * 1e3, bound_ms(nbytes)
        ms = cuda_ms(lambda: flash_attention(q, k, v, block_q=bq, block_k=bk, **kw))
        lib_ms = cuda_ms(sdpa)
        log(f"phase h: flash_attention {label}: {flops:.4e} flop, {nbytes} bytes; ms {ms:.6f} "
            f"bound_ms {max(t_ops, t_bytes):.6f} ({'operations' if t_ops >= t_bytes else 'bytes'}; "
            f"bytes {t_bytes:.6f}) sdpa_ms {lib_ms:.6f} (sdpa vs kernel max_abs_err {lib_err}); "
            f"{flops / ms / 1e9:.1f} TFLOP/s, {ms / lib_ms:.4f} x sdpa")
        if label == "serving":
            result = {
                "name": "flash_attention", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/attention_kernels.cu",
                "replaces": "src/repro/kernels/flash_attention.py:98",
                "max_abs_err": err, "ms": ms,
                "plain_ms": cuda_ms(lambda: flash_attention_ref(q, k, v, block_k=bk, **kw),
                                    iters=5),
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": lib_ms,
            }
            log(f"phase h: flash_attention serving shape: plain_ms {result['plain_ms']:.6f}")
        del qt, kt, vt
    # shapes the kernel does not take go to the chunked softmax, a route
    # chosen from the shapes before any launch: hd 256 and 72 query heads a
    # KV head, at S = 128 (where the JAX opt-in path takes its kernel)
    from repro_torch.models.attention import _full_attention

    for label, B, S, H, KV, hd in (("hd 256", 2, 128, 8, 4, 256),
                                   ("H / KV = 72", 2, 128, 72, 1, 64)):
        q = torch.randn((B, S, H, hd), generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn((B, S, KV, hd), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((B, S, KV, hd), generator=g, device=dev).to(torch.bfloat16)
        before = flash_attention.launches
        got = _full_attention(q, k, v, causal=True)
        want = flash_attention_ref(q, k, v, causal=True, block_k=128)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        log(f"phase h: _full_attention {label} (B {B}, S {S}, H {H}, KV {KV}, hd {hd}): "
            f"flash launches {flash_attention.launches - before}, max_abs_err against the "
            f"plain flash version {err}")
        check(flash_attention.launches == before,
              f"_full_attention {label}: launched the flash kernel, which does not take it")
        check(err <= FLASH_TOL, f"_full_attention {label}: max_abs_err {err} > {FLASH_TOL}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return [result]


def busy_share(prof, wall: float, top: int = 6) -> str:
    """Device busy time and idle share of a traced window, and the ``top``
    device kernels by time."""
    from torch.autograd import DeviceType

    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
    busy = sum(by_name.values())
    if not busy:
        return f"wall {wall:.6f} s; device busy time not measured (no device events)"
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return (f"wall {wall:.6f} s, device busy {busy:.6f} s (idle share {1 - busy / wall:.6f}); "
            "top: " + "; ".join(f"{sec:.6f} s {name[:60]}" for name, sec in heavy))


def kernel_classes(prof) -> str:
    """Device time of a traced window by kernel class: f32 GEMMs (cuBLAS
    names with ``f32f32`` or ``sgemm``), other GEMMs, elementwise kernels,
    reductions and the rest."""
    from torch.autograd import DeviceType

    by: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        n = e.name.lower()
        if any(w in n for w in ("gemm", "xmma", "nvjet", "cutlass")):
            cls = "f32 GEMM" if ("f32f32" in n or "sgemm" in n) else "bf16 GEMM"
        elif "elementwise" in n:
            cls = "elementwise"
        elif "reduce" in n:
            cls = "reduction"
        else:
            cls = "other"
        by[cls] = by.get(cls, 0.0) + e.time_range.elapsed_us() / 1e6
    return "; ".join(f"{cls} {sec:.6f} s" for cls, sec in sorted(by.items(), key=lambda kv: -kv[1]))


def sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def drive_serving(counters: "Counters", device: str = "cuda", cfg=None,
                  prompts: tuple = SERVE_PROMPTS) -> dict:
    """Phase (h), serving part: minitron-4b at full width and depth on the
    card, parameters drawn there from a seeded generator; a ServeEngine
    answers three greedy requests of SERVE_NEW tokens (after one warm-up),
    each checked against teacher forcing; then one prefill and one decode
    step under torch.profiler.  (``device="cpu"`` with a reduced ``cfg`` and
    short ``prompts`` rehearses the phase on the CPU.)"""
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models import count_params, get_model
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServeEngine

    cfg = cfg or ARCHS[SERVE_ARCH]
    bundle = get_model(cfg)
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device=device).manual_seed(SEED), device=device)
    sync(device)
    n_params = sum(t.numel() for _, t in _leaves(params))
    n_norms = sum(t.numel() for name, t in _leaves(params) if "norm" in name)
    log(f"phase h: {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads}, hd {cfg.resolved_head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}: {n_params} parameters (count_params "
        f"{count_params(cfg)}), {n_params * 2 / 1e9:.3f} GB bf16, drawn on {device} in "
        f"{time.perf_counter() - t0:.3f} s")
    check(n_params - n_norms == count_params(cfg),  # it counts no norm scales
          "phase h: parameter count differs from count_params")

    rec = LogitLog(bundle)  # the logits of the prefill and every decode step
    engine = ServeEngine(rec.bundle, params, max_len=max(prompts) + SERVE_NEW,
                         batch=SERVE_BATCH, device=device)
    rng = np.random.default_rng(SEED)
    prompt = lambda S: rng.integers(0, cfg.vocab, (SERVE_BATCH, S)).astype(np.int32)
    t0 = time.perf_counter()
    engine.generate({"tokens": prompt(prompts[0])}, max_new_tokens=2)  # warm-up
    log(f"phase h: warm-up request in {time.perf_counter() - t0:.3f} s")
    out = {}
    on_card = device == "cuda"
    fails = []
    for S in prompts:
        tokens = prompt(S)
        rec.logits.clear()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        counters.zero()
        res = engine.generate({"tokens": tokens}, max_new_tokens=SERVE_NEW)
        flash = on_card and S % 128 == 0  # the CPU runs the plain version
        counts = counters.read(f"phase h (prompt {S})", ("flash_attention",) if flash else ())
        want = cfg.n_layers if flash else 0
        check(counts["flash_attention"] == want,
              f"phase h: prompt {S} launched flash_attention {counts['flash_attention']} "
              f"times, not {want}")
        peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
        check(res.tokens.shape == (SERVE_BATCH, SERVE_NEW), f"phase h: tokens {res.tokens.shape}")
        decode_tps = (res.steps - 1) * SERVE_BATCH / res.decode_s
        log(f"phase h: prompt {S}: prefill {res.prefill_s:.6f} s "
            f"({SERVE_BATCH * S / res.prefill_s:.1f} prompt tok/s), {res.steps - 1} decode "
            f"steps in {res.decode_s:.6f} s ({decode_tps:.1f} tok/s, "
            f"{res.decode_s / (res.steps - 1) * 1e3:.3f} ms a step), peak device memory "
            f"{peak:.3f} GiB")
        out[S] = {"prefill_s": res.prefill_s, "decode_s": res.decode_s,
                  "decode_tok_s": decode_tps, "peak_gib": peak,
                  "flash_launches": counts["flash_attention"]}
        # two routes to the teacher's logits: over the tokens padded to a
        # multiple of 128 (the flash kernel) and over them as they are (the
        # chunked softmax); the prefill is held against its own route's
        full = torch.cat([torch.as_tensor(tokens, dtype=torch.int64),
                          torch.as_tensor(res.tokens[:, :-1], dtype=torch.int64)], 1).to(device)
        n = full.shape[1]
        flash = teacher_logits(cfg, tf, params, full, S, -(-n // 128) * 128)
        chunked = teacher_logits(cfg, tf, params, full, S, n)
        want, other = (flash, chunked) if S % 128 == 0 else (chunked, flash)
        fails += hold_to_teacher("h", f"prompt {S}", rec.logits, res.tokens, want[:, 0], want,
                                 other)[0]

    # one prefill and one decode step under the profiler
    tokens = torch.as_tensor(prompt(prompts[0]), dtype=torch.int64, device=device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.no_grad():
        cache = engine._cache0
        for label, call in (
            ("prefill", lambda: bundle.prefill(params, {"tokens": tokens}, cache)),
            ("decode step", lambda: bundle.decode_step(params, tokens[:, -1:], cache,
                                                       prompts[0])),
        ):
            sync(device)
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                call()
                sync(device)
                wall = time.perf_counter() - t0
            log(f"phase h: traced {label} (prompt {prompts[0]}): {busy_share(prof, wall)}")
        for seg in cache:
            for unit in seg:
                for t in unit.values():
                    t.zero_()
    del params, engine
    if on_card:
        torch.cuda.empty_cache()
    check(not fails, "phase h: " + "; ".join(fails))
    return out


def _leaves(tree, name=""):
    """(name, tensor) of every leaf of a parameter tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, k)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v, name)
    else:
        yield name, tree


def teacher_logits(cfg, tf, params, tokens, S: int, length: int):
    """Teacher-forcing logits (B, n, vocab) f32 at positions S - 1 onward of
    ``tokens`` (B, n + S - 1), computed over ``length`` tokens: the tokens
    padded with token 0, which no earlier position sees (causal)."""
    import torch

    B, n = tokens.shape[0], tokens.shape[1] - S + 1
    pad = torch.zeros((B, length - tokens.shape[1]), dtype=tokens.dtype, device=tokens.device)
    with torch.no_grad():
        hidden, _ = tf.forward_hidden(cfg, params, torch.cat([tokens, pad], 1))
        out = tf.lm_logits(cfg, params, hidden[:, S - 1:S - 1 + n]).float()
    return out[..., :cfg.vocab]


def hold_to_teacher(phase: str, label: str, recorded: list, generated, pre, want,
                    other) -> tuple:
    """Hold one request against teacher forcing (phases (h) and (o)): the
    prefill's logits against ``pre`` (B, vocab), a teacher's at the prompt's
    last position computed as the prefill computes it, at rtol = atol = 2e-2
    (the reference test's tolerance; it is the same arithmetic).  A decode
    step rounds otherwise, and through 30-odd bf16 layers such a difference
    reaches a few tenths of a logit, as far as two routes to the same
    logits part: each decode step must be within the reference test's 5e-2
    of the teacher over the whole request (``want``, (B, new, vocab)), or
    within twice the gap of the two routes (``want`` and ``other``) at that
    position, max and mean.  Every greedy token must equal the teacher's
    argmax where its top-2 margin exceeds twice both that gap and the step's
    own difference, and every logit must be finite.  Returns (failures,
    summary)."""
    import torch

    got = torch.stack(recorded, dim=1)                       # (B, new, vocab)
    fails, report = [], []
    pre_diff = (got[:, 0] - pre).abs()
    pre_ratio = float((pre_diff / (2e-2 + 2e-2 * pre.abs())).max())
    if pre_ratio > 1.0:
        fails.append(f"{label}: prefill logits differ from the teacher by "
                     f"{float(pre_diff.max())} (allclose ratio {pre_ratio} at 2e-2)")
    diff, gap = (got - want).abs(), (want - other).abs()
    worst = {"max_abs": 0.0, "ratio": 0.0}
    for i in range(1, got.shape[1]):
        err, mean = float(diff[:, i].max()), float(diff[:, i].mean())
        ratio = float((diff[:, i] / (5e-2 + 5e-2 * want[:, i].abs())).max())
        floor, floor_mean = float(gap[:, i].max()), float(gap[:, i].mean())
        worst = {"max_abs": max(worst["max_abs"], err), "ratio": max(worst["ratio"], ratio)}
        if ratio > 1.0 and not (err <= 2 * floor and mean <= 2 * floor_mean):
            fails.append(f"{label}: decode step {i} differs from teacher forcing by {err} (mean "
                         f"{mean}; allclose ratio {ratio} at 5e-2; the routes differ by {floor}, "
                         f"mean {floor_mean})")
        report.append(f"{err:.4f}/{floor:.4f}")
    top2 = want.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    sure = (margin > 2 * torch.maximum(gap.amax(-1), diff.amax(-1))).cpu().numpy()
    teacher = want.argmax(dim=-1).cpu().numpy()
    disagree = int((teacher[sure] != generated[sure]).sum())
    if disagree:
        fails.append(f"{label}: {disagree} greedy tokens differ from teacher forcing where its "
                     "margin is clear")
    if not (bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())):
        fails.append(f"{label}: non-finite logits")
    summary = {"prefill_max_abs": float(pre_diff.max()), "prefill_ratio": pre_ratio,
               "decode_max_abs": worst["max_abs"], "decode_ratio": worst["ratio"],
               "route_gap_max": float(gap[:, 1:].max()), "route_gap_mean": float(gap[:, 1:].mean()),
               "sure": int(sure.sum()), "disagree": disagree}
    log(f"phase {phase}: {label}: prefill against the teacher max abs "
        f"{summary['prefill_max_abs']:.6f} (allclose ratio {pre_ratio:.4f} at 2e-2); decode "
        f"steps 1-{got.shape[1] - 1} against the request's teacher max abs "
        f"{summary['decode_max_abs']:.6f} (allclose ratio {summary['decode_ratio']:.4f} at "
        f"5e-2), the two routes' gap max {summary['route_gap_max']:.6f} mean "
        f"{summary['route_gap_mean']:.6f}; max abs / route gap by step: {' '.join(report)}; "
        f"{summary['sure']} of {sure.size} tokens past the margin, {disagree} differ from the "
        "teacher's argmax")
    return fails, summary


# ------------------------------------------------------- (m), (n) MoE serving
DS_ARCH = "deepseek-v3-671b"
DS_LAYERS = 5            # of 61: 3 dense + 2 MoE, what the card's 80 GB holds
DS_CHECK_TOKENS = 1024   # the MoE layer check, one row
DS_PROMPT = 512          # the two greedy requests (batch 2), one per cache form
DS_NEW = 16
DS_BATCH = 2
DS_TIMED = (4, 1024, 16)  # batch, prompt, decode steps at the published cf
PHI_ARCH = "phi3.5-moe-42b-a6.6b"
PHI_LAYERS = 16          # of 32
PHI_BATCH = 4
PHI_PROMPTS = (2048, 1000)  # the flash kernel, the chunked softmax
PHI_NEW = 16
PHI_EP_PROMPT = 2048     # the request (n) runs again with moe_impl="ep"
MOE_TOL = 2e-2           # the MoE layer against its plain sum, ||d|| / ||plain|| a token
MOE_REL_TOL = 0.1        # a decode step's logits against teacher forcing, ||d - t|| / ||t||


class RouteLog:
    """While active, records the top-k experts (B, S, K) of every MoE layer
    call, in call order, by wrapping ``repro_torch.models.moe.route``."""

    def __enter__(self):
        from repro_torch.models import moe

        self.calls, self._moe, self._route = [], moe, moe.route

        def route(cfg, logits):
            top_w, top_e = self._route(cfg, logits)
            self.calls.append(top_e)
            return top_w, top_e

        moe.route = route
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route


@contextlib.contextmanager
def ep_router():
    """While active, ``moe.router_logits`` is the EP form's (the router cast
    to ``x``'s dtype, a bf16 product), so that a plain sum or a teacher
    routes and weighs as ``moe_block_ep`` does."""
    from repro_torch.models import moe, moe_ep

    saved = moe.router_logits
    moe.router_logits = moe_ep.router_logits
    try:
        yield
    finally:
        moe.router_logits = saved


def moe_layer_check_ep(phase: str, cfg, params, tokens) -> dict:
    """``moe_block_ep`` on the card's 1 x 1 NCCL mesh against
    ``moe_block_plain`` over the EP form's own routes (:func:`ep_router`),
    on the first MoE layer's real input, drop-free: every token within
    MOE_TOL of the plain sum's norm, two all-to-alls and one all-gather a
    call; a planted fault (the first all-to-all of the call hands each
    expert's tokens to the next expert) must land above MOE_TOL.  Logs how
    many tokens' top-k sets the EP form's bf16 router and the dispatch's f32
    router choose differently, and the EP call's wall (one call, after one
    untimed)."""
    import dataclasses

    import torch

    from repro_torch.distributed.sharding import logical_sharding
    from repro_torch.models import moe, moe_ep

    free = drop_free(cfg)
    ep_cfg = dataclasses.replace(free, moe_impl="ep")
    p, x = moe_layer_input(free, params, tokens)
    mesh = host_mesh()
    with torch.no_grad():
        f32_e = moe.route(free, moe.router_logits(p, x))[1].sort(dim=-1).values
        bf16_e = moe.route(free, moe_ep.router_logits(p, x))[1].sort(dim=-1).values
        differ = int((f32_e != bf16_e).any(-1).sum())
        with logical_sharding(mesh):
            moe_ep.moe_block_ep(ep_cfg, p, x)  # warm-up: NCCL makes its communicator
            a2a, ag = moe_ep.all_to_all.calls, moe_ep.all_gather.calls
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = moe_ep.moe_block_ep(ep_cfg, p, x)
            torch.cuda.synchronize()
            ep_s = time.perf_counter() - t0
            a2a, ag = moe_ep.all_to_all.calls - a2a, moe_ep.all_gather.calls - ag
            good, calls = moe_ep._exchange, []

            def shifted(t, group):
                calls.append(1)
                return good(t.roll(1, dims=1) if len(calls) == 1 else t, group)

            moe_ep._exchange = shifted
            try:
                fault = moe_ep.moe_block_ep(ep_cfg, p, x)
            finally:
                moe_ep._exchange = good
        with ep_router():
            want = moe.moe_block_plain(free, p, x)
        norm = want.float().norm(dim=-1)
        rel = (got.float() - want.float()).norm(dim=-1) / norm
        rel_fault = (fault.float() - want.float()).norm(dim=-1) / norm
    S, E = x.shape[1], cfg.n_experts
    c_loc = max(1, -(-x.shape[0] * S * cfg.top_k * ep_cfg.capacity_factor // E))
    log(f"phase {phase}: moe_block_ep on the 1 x 1 NCCL mesh against the plain sum over its "
        f"own routes, on the first MoE layer's input {tuple(x.shape)}, drop-free (c_loc "
        f"{int(c_loc)}, two all-to-alls of ({E}, {int(c_loc)}, {cfg.d_model}) bf16 each way): a "
        f"token's ||d|| / ||plain|| max {float(rel.max()):.6f}; the planted fault (tokens "
        f"handed to the next expert) min {float(rel_fault.min()):.6f} max "
        f"{float(rel_fault.max()):.6f}; {a2a} all-to-alls and {ag} all-gather a call; "
        f"moe_block_ep {ep_s:.6f} s (one call); the bf16 router's top-{cfg.top_k} set differs "
        f"from the dispatch's f32 router's at {differ} of {f32_e.shape[0] * f32_e.shape[1]} "
        "tokens")
    check(a2a == 2 and ag == 1, f"phase {phase}: moe_block_ep issued {a2a} all-to-alls and "
          f"{ag} all-gathers, not 2 and 1")
    check(float(rel.max()) <= MOE_TOL, f"phase {phase}: moe_block_ep differs from the plain "
          f"sum by {float(rel.max())} of a token's norm (tolerance {MOE_TOL})")
    check(float(rel_fault.max()) > MOE_TOL, f"phase {phase}: the planted fault lands under "
          f"{MOE_TOL}: {float(rel_fault.max())}")
    return {"max_rel": float(rel.max()), "fault_max_rel": float(rel_fault.max()),
            "ep_s": ep_s, "router_sets_differ": differ}


def moe_model(name: str, n_layers: int, phase: str):
    """The published config of ``name`` cut to ``n_layers``, and its
    parameters drawn on the card from a seeded generator."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models import count_params, get_model

    full = ARCHS[name]
    cfg = dataclasses.replace(full, n_layers=n_layers)
    t0 = time.perf_counter()
    params = get_model(cfg).init(torch.Generator(device="cuda").manual_seed(SEED),
                                 device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in _leaves(params))
    n_norms = sum(t.numel() for name_, t in _leaves(params) if "norm" in name_)
    pad = (cfg.padded_vocab - cfg.vocab) * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    log(f"phase {phase}: {cfg.name} at its published widths (d {cfg.d_model}, {cfg.n_heads} "
        f"heads, {cfg.n_experts} experts top {cfg.top_k} of d_ff {cfg.expert_d_ff}, "
        f"{cfg.n_shared_experts} shared, dense d_ff {cfg.d_ff}, vocab {cfg.vocab} padded to "
        f"{cfg.padded_vocab}), depth cut from {full.n_layers} to {cfg.n_layers} layers "
        f"({min(cfg.n_dense_layers, cfg.n_layers)} dense, "
        f"{max(0, cfg.n_layers - cfg.n_dense_layers)} MoE{', the MTP head' if cfg.mtp else ''})"
        f": {n_params} parameters, {n_params * 2 / 1e9:.3f} GB bf16, drawn on the card in "
        f"{time.perf_counter() - t0:.3f} s; the published depth: {count_params(full)} "
        f"parameters by count_params, {count_params(full) * 2 / 1e12:.3f} TB bf16")
    # count_params counts no norm scales nor the vocab's padding, and counts
    # an MTP block as a GQA block (ROADMAP Queue 3)
    D, H, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    gqa = D * H * hd + 2 * D * cfg.n_kv_heads * hd + H * hd * D
    mla = (D * cfg.q_lora_rank + cfg.q_lora_rank * H * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
           + D * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
           + cfg.kv_lora_rank * H * (cfg.qk_nope_head_dim + cfg.v_head_dim)
           + H * cfg.v_head_dim * D)
    miscount = gqa - mla if cfg.mtp and cfg.blocks()[-1] == "mla" else 0
    check(n_params - n_norms == count_params(cfg) + pad - miscount,
          f"phase {phase}: {n_params - n_norms} parameters against count_params "
          f"{count_params(cfg)} + {pad} padding - {miscount} (MTP counted as GQA)")
    return cfg, params


def drop_free(cfg):
    """``cfg`` at capacity E / K: no route is ever dropped (as ``reduced()``)."""
    import dataclasses

    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


def moe_layer_input(cfg, params, tokens):
    """The (params, input) of the model's first MoE layer on ``tokens``: a
    real layer input, taken by wrapping ``moe.moe_block`` through one
    teacher-forcing pass."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models import transformer as tf

    with torch.no_grad(), Capture(moe, "moe_block") as block:
        tf.forward_hidden(cfg, params, tokens)
    return block.args[1], block.args[2]


def moe_layer_check(phase: str, cfg, params, tokens) -> dict:
    """``moe_block`` against ``moe_block_plain`` (each token's routes summed
    expert by expert, no capacity, no dispatch) on the model's first MoE
    layer input, drop-free: every token within MOE_TOL of the plain sum's
    norm, no route dropped.  Then at the published capacity factor on the
    same input: the dispatch drops routes, and the plain sum must single out
    the tokens that lost one (they differ, the others stay within MOE_TOL),
    which shows the check sees a lost route.  Both are timed once."""
    import torch

    from repro_torch.models import moe

    free = drop_free(cfg)
    p, x = moe_layer_input(free, params, tokens)
    S, E = x.shape[1], cfg.n_experts
    with torch.no_grad():
        top_e = moe.route(free, moe.router_logits(p, x))[1]
        lost = int((moe.positions(top_e, E) >= moe.capacity(free, S)).sum())
        t0 = time.perf_counter()
        got = moe.moe_block(free, p, x)
        torch.cuda.synchronize()
        block_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = moe.moe_block_plain(free, p, x)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err = (got.float() - want.float()).abs()
        rel = (got.float() - want.float()).norm(dim=-1) / want.float().norm(dim=-1)
        C = moe.capacity(cfg, S)
        dropped = (moe.positions(top_e, E) >= C).any(-1)            # (B, S) a token lost one
        at_cf = moe.moe_block(cfg, p, x)
        rel_cf = (at_cf.float() - want.float()).norm(dim=-1) / want.float().norm(dim=-1)
    kept = _max(rel_cf[~dropped])
    lost_rel = rel_cf[dropped]
    log(f"phase {phase}: moe_block against its plain per-token sum on the first MoE layer's "
        f"input ({tuple(x.shape)}, drop-free capacity {moe.capacity(free, S)}, buffers "
        f"({E}, {x.shape[0]}, {moe.capacity(free, S) + 1}, {cfg.d_model})): a token's "
        f"||d|| / ||plain|| max {float(rel.max()):.6f}, max abs {float(err.max()):.6f}, "
        f"{lost} routes dropped; moe_block {block_s:.6f} s, plain {plain_s:.6f} s (one call "
        f"each). At cf {cfg.capacity_factor} (C = {C}): "
        f"{int(dropped.sum())} of {dropped.numel()} tokens lost a route, their ||d|| / "
        f"||plain|| min {float(lost_rel.min()) if lost_rel.numel() else 0.0:.6f} median "
        f"{float(lost_rel.median()) if lost_rel.numel() else 0.0:.6f}; the other tokens' max "
        f"{kept:.6f}")
    check(lost == 0, f"phase {phase}: {lost} routes dropped at drop-free capacity")
    check(float(rel.max()) <= MOE_TOL, f"phase {phase}: moe_block differs from its plain "
          f"sum by {float(rel.max())} of a token's norm (tolerance {MOE_TOL})")
    check(bool((lost_rel > 0).all()) and kept <= MOE_TOL,
          f"phase {phase}: at cf {cfg.capacity_factor} the plain sum does not single out the "
          f"{int(dropped.sum())} tokens that lost a route (kept tokens' max {kept})")
    return {"max_abs_err": float(err.max()), "moe_block_s": block_s, "plain_s": plain_s,
            "cf_dropped_tokens": int(dropped.sum())}


class LogitLog:
    """Wraps a bundle's prefill and decode_step to keep the last position's
    logits (B, vocab) f32 of every call."""

    def __init__(self, bundle):
        import dataclasses

        self.logits = []

        def record(fn):
            def wrapped(*args):
                logits, cache = fn(*args)
                self.logits.append(logits[:, -1, :bundle.cfg.vocab].float().clone())
                return logits, cache
            return wrapped

        self.bundle = dataclasses.replace(bundle, prefill=record(bundle.prefill),
                                          decode_step=record(bundle.decode_step))


def _max(t) -> float:
    return float(t.max()) if t.numel() else 0.0


class ForcedRoutes:
    """While active, an MoE model runs as a plain, dispatch-free reference on
    routes handed to it: each MoE layer is ``moe_block_plain`` (each token's
    experts summed expert by expert), whose routes are ``routes[i]`` (B, n, K)
    for the i-th MoE layer call at its first n positions (its own beyond
    them), weighted by its own gates at those experts.  ``flipped[i]`` (B, n)
    marks the tokens whose own top-k set differs from the one handed over."""

    def __init__(self, routes: list):
        self.routes, self.flipped = routes, []

    def __enter__(self):
        import torch

        from repro_torch.models import moe

        self._moe, self._route, self._block = moe, moe.route, moe.moe_block

        def route(cfg, logits):
            _, own = self._route(cfg, logits)
            forced = self.routes[len(self.flipped)]
            n = forced.shape[1]
            top_e = torch.cat([forced, own[:, n:]], dim=1)
            top_w = torch.softmax(logits, dim=-1).gather(-1, top_e)
            self.flipped.append((own[:, :n].sort(dim=-1).values
                                 != forced.sort(dim=-1).values).any(-1))
            return top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9), top_e

        moe.route, moe.moe_block = route, moe.moe_block_plain
        return self

    def __exit__(self, *exc):
        self._moe.route, self._moe.moe_block = self._route, self._block


class ChunkedRoute:
    """While active, every attention of a forward pass takes the chunked
    softmax with key chunks of ``chunk`` (the flash kernel never runs)."""

    def __init__(self, chunk: int):
        self.chunk = chunk

    def __enter__(self):
        import functools

        from repro_torch.models import attention

        self._attention = attention
        self._saved = attention._full_attention, attention.chunked_attention
        chunked = functools.partial(self._saved[1], chunk=self.chunk)
        attention.chunked_attention = chunked
        attention._full_attention = lambda q, k, v, *, causal: chunked(q, k, v, causal=causal)
        return self

    def __exit__(self, *exc):
        self._attention._full_attention, self._attention.chunked_attention = self._saved


def moe_teacher_force(phase: str, cfg, params, prompt, generated, logits: list,
                      engine_routes: list) -> tuple:
    """Hold one request of an MoE model against teacher forcing over its
    prompt and generated tokens, drop-free.

    The teacher is a plain reference on the request's own routes
    (:class:`ForcedRoutes`): every MoE layer computes ``sum_k w_k ·
    FFN_{e_k}(x)`` token by token with no capacity, slots or buffers, on the
    experts the engine chose for that token (prefill and decode steps), with
    weights from its own gates.  Routes are discrete: where a token's K-th
    and (K+1)-th gates lie within bf16 noise of each other, two bf16 paths
    may choose differently, and the token's state then moves by a whole
    expert's output in every later layer.  Handing the teacher the engine's
    routes leaves only the continuous bf16 differences; the flips are
    counted and printed (the teacher's own top-k against the engine's), not
    hidden.

    The prefill's last logits must equal those of a teacher over the prompt
    alone within rtol = atol = 2e-2, as phase (h) holds them: the same
    attention route and, unlike a teacher over the whole request, the same
    tokens an expert's GEMM gets (cuBLAS picks its kernel, and so its
    rounding, by the GEMM's size).  The decode steps are held against a
    teacher over the whole request (padded to a multiple of 128 where the
    prefill took the flash kernel).  A decode step attends through the
    one-query softmax, which rounds otherwise, and at random weights 16 MoE
    layers carry such rounding to 5-10% of the logits' norm: each decode
    step must be within MOE_REL_TOL of the
    teacher's norm (||d - t|| / ||t||), or within twice the gap of two
    chunked-softmax teachers on the same routes that differ only in their
    key chunk (1024 and 256), a gauge of that rounding that takes neither
    the flash kernel nor the decode path.  A route sent to a wrong slot, a
    wrong weight or a lost route moves a token's logits by a large part of
    their norm, and the layer check (:func:`moe_layer_check`) holds the
    dispatch to 2e-2 of a token's norm.  Returns (failures, summary)."""
    import torch

    from repro_torch.models import transformer as tf

    S, new = prompt.shape[1], generated.shape[1]
    full = torch.cat([torch.as_tensor(prompt, dtype=torch.int64),
                      torch.as_tensor(generated[:, :-1], dtype=torch.int64)], 1)
    full = full.to(params["embed"].device)
    n = full.shape[1]
    n_moe = cfg.n_layers - min(cfg.n_dense_layers, cfg.n_layers)
    length = -(-n // 128) * 128 if S % 128 == 0 else n      # the engine's attention route
    routes = [torch.cat(engine_routes[i::n_moe], dim=1) for i in range(n_moe)]
    with ForcedRoutes([r[:, :S] for r in routes]):
        pre = teacher_logits(cfg, tf, params, full[:, :S], S, S)[:, 0]
    with ForcedRoutes(routes) as fr:
        want = teacher_logits(cfg, tf, params, full, S, length)
    gauge = []
    for chunk in (1024, 256):
        with ForcedRoutes(routes), ChunkedRoute(chunk):
            gauge.append(teacher_logits(cfg, tf, params, full, S, n))
    gap = ((gauge[0] - gauge[1]).norm(dim=-1) / gauge[0].norm(dim=-1))[:, 1:]
    bound = max(MOE_REL_TOL, 2 * _max(gap))
    flipped = torch.stack(fr.flipped)                        # (n_moe, B, n)
    got = torch.stack(logits[:new], dim=1)                   # (B, new, vocab)
    diff = (got - want).abs()
    rel = diff.norm(dim=-1) / want.norm(dim=-1)
    pre_diff = (got[:, 0] - pre).abs()
    pre_ratio = float((pre_diff / (2e-2 + 2e-2 * pre.abs())).max())
    argmax_same = int((want.argmax(-1).cpu().numpy() == generated).sum())
    summary = {"routes_differed": int(flipped.sum()), "token_layers": flipped.numel(),
               "tokens_flipped": int(flipped.any(0).sum()), "max_rel": _max(rel[:, 1:]),
               "mean_rel": float(rel[:, 1:].mean()), "prefill_max_abs": float(pre_diff.max()),
               "prefill_ratio": pre_ratio, "max_abs": float(diff.max()),
               "chunk_gap": _max(gap), "bound": bound, "teacher_length": length}
    log(f"phase {phase}: prompt {S}: teacher forcing over {n} tokens (run at {length}) on the "
        f"request's routes: the teacher's own top-{cfg.top_k} differed in "
        f"{summary['routes_differed']} of {summary['token_layers']} (token, MoE layer) pairs, "
        f"at {summary['tokens_flipped']} of {flipped.shape[1] * flipped.shape[2]} tokens; "
        f"prefill against the prompt's teacher max abs {summary['prefill_max_abs']:.6f} "
        f"(allclose ratio {pre_ratio:.4f} at 2e-2), against the whole request's max abs "
        f"{float(diff[:, 0].max()):.6f}, ||d - t|| / ||t|| {float(rel[:, 0].max()):.6f}; decode "
        f"||d - t|| / ||t|| max "
        f"{summary['max_rel']:.6f} mean {summary['mean_rel']:.6f}, max abs "
        f"{_max(diff[:, 1:]):.6f}; chunk 1024 and 256 teachers' decode gap ||.|| / ||t|| max "
        f"{summary['chunk_gap']:.6f}; bound {bound:.6f}; {argmax_same} of {generated.size} "
        "greedy tokens equal the teacher's argmax")
    fails = []
    if pre_ratio > 1.0:
        fails.append(f"prompt {S}: the prefill's logits differ from teacher forcing by "
                     f"{summary['prefill_max_abs']} (allclose ratio {pre_ratio} at rtol = atol "
                     "= 2e-2)")
    if summary["max_rel"] > bound:
        b, j = [int(v) for v in torch.nonzero(rel[:, 1:] > bound)[0]]
        fails.append(f"prompt {S}: {int((rel[:, 1:] > bound).sum())} decode steps differ from "
                     f"teacher forcing by more than {bound} of its norm (first: row {b}, "
                     f"step {j + 1}: {float(rel[b, j + 1])})")
    if not bool(torch.isfinite(want).all()) or not bool(torch.isfinite(got).all()):
        fails.append(f"prompt {S}: non-finite logits")
    return fails, summary


def timed_moe_run(phase: str, cfg, bundle, params, batch: int, S: int, steps: int,
                  label: str) -> dict:
    """A prefill of batch x S tokens and ``steps`` decode steps through a
    ServeEngine at ``cfg``'s capacity factor: walls, peak memory, the share
    of routes dropped; then one decode step under torch.profiler, beside the
    bytes it needs: the weights it multiplies (the experts its routes
    select, not all E) and its cache up to its position."""
    import torch

    from repro_torch.models import moe
    from repro_torch.serving import ServeEngine

    max_len = S + steps + 1
    engine = ServeEngine(bundle, params, max_len=max_len, batch=batch, device="cuda")
    tokens = np.random.default_rng(SEED + S).integers(0, cfg.vocab, (batch, S)).astype(np.int32)
    engine.generate({"tokens": tokens}, max_new_tokens=2)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    with RouteLog() as rl:
        res = engine.generate({"tokens": tokens}, max_new_tokens=steps + 1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_moe = cfg.n_layers - min(cfg.n_dense_layers, cfg.n_layers)
    C, C1 = moe.capacity(cfg, S), moe.capacity(cfg, 1)
    pre = [(moe.positions(e, cfg.n_experts) >= C) for e in rl.calls[:n_moe]]
    dec = [(moe.positions(e, cfg.n_experts) >= C1) for e in rl.calls[n_moe:]]
    share = float(sum(int(d.sum()) for d in pre)) / max(1, sum(d.numel() for d in pre))
    dec_share = float(sum(int(d.sum()) for d in dec)) / max(1, sum(d.numel() for d in dec))
    step_s = res.decode_s / (res.steps - 1)
    out = {"prefill_s": res.prefill_s, "decode_step_s": step_s, "peak_gib": peak,
           "dropped_share": share, "decode_dropped_share": dec_share,
           "dropped_by_layer": [float(d.float().mean()) for d in pre]}
    log(f"phase {phase}: {label}: prefill of {batch} x {S} tokens at cf {cfg.capacity_factor} "
        f"(C = {C}) {res.prefill_s:.6f} s ({batch * S / res.prefill_s:.1f} tok/s), routes "
        f"dropped {share:.6f} (by MoE layer {', '.join(f'{v:.6f}' for v in out['dropped_by_layer'])}); "
        f"{res.steps - 1} decode steps in {res.decode_s:.6f} s ({step_s * 1e3:.3f} ms a step, C = "
        f"{C1}, routes dropped {dec_share:.6f}); peak device memory {peak:.3f} GiB")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    cache = engine._cache0
    tok = torch.as_tensor(tokens[:, -1:], dtype=torch.int64, device="cuda")
    with torch.no_grad():
        bundle.prefill(params, {"tokens": torch.as_tensor(tokens, dtype=torch.int64,
                                                           device="cuda")}, cache)
        bundle.decode_step(params, tok, cache, S)  # untraced, to warm the step
        torch.cuda.synchronize()
        with RouteLog() as step_routes, torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            bundle.decode_step(params, tok, cache, S + 1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    cache_bytes = 0
    for seg in cache:
        for unit in seg:
            for t in unit.values():
                check(max_len in t.shape, f"phase {phase}: a cache leaf {tuple(t.shape)} has "
                      f"no axis of {max_len} positions")
                cache_bytes += t.numel() * t.element_size() * (S + 2) // max_len
                t.zero_()
    # the weights a step multiplies: all but the MTP head and the (untied)
    # embedding, of which it reads the batch's rows; of the routed experts
    # those its routes select
    check(not cfg.tie_embeddings, f"phase {phase}: {cfg.name} ties its embeddings")
    expert = 3 * cfg.d_model * cfg.expert_d_ff * 2
    all_experts = n_moe * cfg.n_experts * expert
    weights = sum(t.numel() * t.element_size() for _, t in _leaves(
        {k: v for k, v in params.items() if k not in ("mtp", "embed")}))
    selected = [int(e.unique().numel()) for e in step_routes.calls]
    check(len(selected) == n_moe, f"phase {phase}: the traced step routed {len(selected)} MoE "
          f"layers, not {n_moe}")
    needed = weights - all_experts + sum(selected) * expert + cache_bytes + batch * cfg.d_model * 2
    bound = needed / HBM_BYTES_PER_S
    log(f"phase {phase}: {label}: traced decode step (batch {batch}, position {S + 1}): "
        f"{busy_share(prof, wall)}; kernel classes: {kernel_classes(prof)}. The bytes it needs: "
        f"{needed / 1e9:.3f} GB ({(weights - all_experts) / 1e9:.3f} GB of weights but the "
        f"routed experts, the {sum(selected)} experts its {batch} x {cfg.top_k} routes select "
        f"({', '.join(map(str, selected))} of {cfg.n_experts} by MoE layer) "
        f"{sum(selected) * expert / 1e9:.3f} GB, its cache up to the position "
        f"{cache_bytes / 1e9:.3f} GB), {bound * 1e3:.3f} ms at 3.35 TB/s: the step is "
        f"{wall / bound:.2f}x that bound, the untraced steps {step_s / bound:.2f}x. The dispatch runs all {cfg.n_experts} experts of "
        f"each of the {n_moe} MoE layers (C = {C1} slot each): {all_experts / 1e9:.3f} GB of "
        f"expert weights, {all_experts / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s, "
        f"{(all_experts - sum(selected) * expert) / HBM_BYTES_PER_S * 1e3:.3f} ms over the "
        "selected experts' read")
    out.update(traced_step_s=wall, expert_gb=all_experts / 1e9, needed_gb=needed / 1e9,
               selected_experts=selected, step_bound_s=bound)
    del engine
    return out


def drive_deepseek(counters: "Counters") -> dict:
    """Phase (m): DeepSeek-V3 at its published widths, 5 of its 61 layers
    (3 dense MLA layers, 2 MLA + MoE layers, the MTP head's parameters),
    drawn on the card.  The MoE layer against its plain sum at full width
    (:func:`moe_layer_check`); two greedy requests of DS_BATCH x DS_PROMPT
    tokens and DS_NEW new tokens, drop-free, one through each MLA cache form
    (full, compressed), each held against teacher forcing
    (:func:`moe_teacher_force`) and against each other; then, at the
    published capacity factor, a timed prefill and decode steps in each cache
    form, one decode step traced.  No kernel of the repo is on this path (MLA
    takes the chunked softmax, as the JAX package does)."""
    import dataclasses

    import torch

    from repro_torch.models import get_model
    from repro_torch.serving import ServeEngine

    S, new, batch = DS_PROMPT, DS_NEW, DS_BATCH
    cfg, params = moe_model(DS_ARCH, DS_LAYERS, "m")
    rng = np.random.default_rng(SEED)
    check_tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (1, DS_CHECK_TOKENS)),
                                   device="cuda")
    out = {"layer": moe_layer_check("m", cfg, params, check_tokens),
           "layer_ep": moe_layer_check_ep("m", cfg, params, check_tokens)}

    prompt = rng.integers(0, cfg.vocab, (batch, S)).astype(np.int32)
    fails, runs = [], {}
    for form, compressed in (("full cache", False), ("compressed cache", True)):
        free = drop_free(dataclasses.replace(cfg, mla_compressed_cache=compressed))
        rec = LogitLog(get_model(free))
        engine = ServeEngine(rec.bundle, params, max_len=S + new, batch=batch, device="cuda")
        counters.zero()
        with RouteLog() as rl:
            res = engine.generate({"tokens": prompt}, max_new_tokens=new)
        counters.read(f"phase m ({form})", ())
        log(f"phase m: {form}: {batch} x {S} prompt tokens, {new} new, drop-free (cf "
            f"{free.capacity_factor}): prefill {res.prefill_s:.6f} s, {res.steps - 1} decode "
            f"steps in {res.decode_s:.6f} s")
        f, summary = moe_teacher_force(f"m ({form})", free, params, prompt, res.tokens,
                                       rec.logits, rl.calls)
        fails += f
        runs[form] = {"tokens": res.tokens, "logits": rec.logits, "teacher": summary}
        del engine
    a, b = runs["full cache"], runs["compressed cache"]
    agree = int((a["tokens"] == b["tokens"]).all(0).cumprod().sum())  # steps before they part
    gaps = [float(((x - y).norm(dim=-1) / y.norm(dim=-1)).max())
            for x, y in zip(a["logits"][:agree + 1], b["logits"][:agree + 1])]
    pre_gap = float((a["logits"][0] - b["logits"][0]).abs().max())
    log(f"phase m: the two cache forms: greedy tokens equal for {agree} of {new} steps; "
        f"prefill logits max abs {pre_gap:.6f}; decode logits ||full - compressed|| / "
        f"||compressed|| over the steps with equal context: max {max(gaps[1:] or [0.0]):.6f}")
    check(pre_gap <= MOE_TOL * (1 + float(b["logits"][0].abs().max())),
          f"phase m: the cache forms' prefill logits differ by {pre_gap}")
    check(not fails, "phase m: " + "; ".join(fails))
    out["requests"] = {k: v["teacher"] for k, v in runs.items()}

    t_batch, t_prompt, t_steps = DS_TIMED
    for form, compressed in (("full cache", False), ("compressed cache", True)):
        timed = dataclasses.replace(cfg, mla_compressed_cache=compressed)
        counters.zero()
        out[form] = timed_moe_run("m", timed, get_model(timed), params, t_batch, t_prompt,
                                  t_steps, form)
        counters.read(f"phase m (timed, {form})", ())
    del params
    torch.cuda.empty_cache()
    return out


def drive_phi(counters: "Counters") -> dict:
    """Phase (n): Phi-3.5-MoE at its published widths, 16 of its 32 layers
    (GQA 32 / 8 heads of 128 and an MoE of 16 experts, top 2, in every
    layer), drawn on the card.  The MoE layer against its plain sum; a
    ServeEngine of batch PHI_BATCH answers greedy requests of PHI_NEW tokens
    with prompts of 2048 tokens (its prefill takes the flash kernel: one
    launch a layer) and 1000 (the chunked softmax), drop-free, each held
    against teacher forcing (:func:`moe_teacher_force`); then one timed
    prefill and decode at the published capacity factor."""
    import torch

    from repro_torch.models import get_model
    from repro_torch.serving import ServeEngine

    new, batch = PHI_NEW, PHI_BATCH
    cfg, params = moe_model(PHI_ARCH, PHI_LAYERS, "n")
    rng = np.random.default_rng(SEED)
    check_tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (1, DS_CHECK_TOKENS)),
                                   device="cuda")
    out = {"layer": moe_layer_check("n", cfg, params, check_tokens),
           "layer_ep": moe_layer_check_ep("n", cfg, params, check_tokens)}
    free = drop_free(cfg)
    rec = LogitLog(get_model(free))
    engine = ServeEngine(rec.bundle, params, max_len=max(PHI_PROMPTS) + new, batch=batch,
                         device="cuda")
    engine.generate({"tokens": rng.integers(0, cfg.vocab, (batch, PHI_PROMPTS[0]))},
                    max_new_tokens=2)  # warm-up
    fails, prompts = [], {}
    for S in PHI_PROMPTS:
        prompt = prompts[S] = rng.integers(0, cfg.vocab, (batch, S)).astype(np.int32)
        rec.logits.clear()
        counters.zero()
        with RouteLog() as rl:
            res = engine.generate({"tokens": prompt}, max_new_tokens=new)
        flash = S % 128 == 0
        counts = counters.read(f"phase n (prompt {S})", ("flash_attention",) if flash else ())
        want = cfg.n_layers if flash else 0
        check(counts["flash_attention"] == want,
              f"phase n: prompt {S} launched flash_attention {counts['flash_attention']} "
              f"times, not {want}")
        log(f"phase n: prompt {S}: {batch} x {S} tokens, {new} new, drop-free: prefill "
            f"{res.prefill_s:.6f} s, {res.steps - 1} decode steps in {res.decode_s:.6f} s, "
            f"flash_attention launches {counts['flash_attention']}")
        f, summary = moe_teacher_force("n", free, params, prompt, res.tokens, rec.logits,
                                       rl.calls)
        fails += f
        out[S] = {"prefill_s": res.prefill_s, "decode_s": res.decode_s,
                  "flash_launches": counts["flash_attention"], "teacher": summary}
    del engine
    out["ep"] = phi_ep_request(counters, cfg, params, prompts[PHI_EP_PROMPT], out[PHI_EP_PROMPT])
    fails += out["ep"].pop("fails")
    check(not fails, "phase n: " + "; ".join(fails))
    counters.zero()
    out["timed"] = timed_moe_run("n", cfg, get_model(cfg), params, batch, PHI_PROMPTS[0], new,
                                 "published cf")
    counters.read("phase n (timed)", ("flash_attention",))
    del params
    torch.cuda.empty_cache()
    return out


def phi_ep_request(counters: "Counters", cfg, params, prompt, dispatch: dict) -> dict:
    """Phase (n)'s request of PHI_BATCH x PHI_EP_PROMPT tokens again, with
    ``moe_impl="ep"`` on the 1 x 1 NCCL mesh, drop-free, through a
    ServeEngine: ``flash_attention`` must launch once a layer, each MoE call
    must issue two all-to-alls, and the request is held against teacher
    forcing over the EP form's own routes (:func:`moe_teacher_force` under
    :func:`ep_router`).  Its prefill and decode walls are logged beside the
    dispatch's on the same prompt (``dispatch``)."""
    import dataclasses

    import torch

    from repro_torch.distributed.sharding import logical_sharding
    from repro_torch.models import get_model, moe_ep
    from repro_torch.serving import ServeEngine

    new, batch, S = PHI_NEW, PHI_BATCH, prompt.shape[1]
    free = drop_free(cfg)
    rec = LogitLog(get_model(dataclasses.replace(free, moe_impl="ep")))
    engine = ServeEngine(rec.bundle, params, max_len=S + new, batch=batch, device="cuda")
    with logical_sharding(host_mesh()):
        engine.generate({"tokens": prompt}, max_new_tokens=2)  # warm-up
        rec.logits.clear()
        counters.zero()
        a2a = moe_ep.all_to_all.calls
        with RouteLog() as rl:
            res = engine.generate({"tokens": prompt}, max_new_tokens=new)
        a2a = moe_ep.all_to_all.calls - a2a
        counts = counters.read(f"phase n (EP, prompt {S})", ("flash_attention",))
    del engine
    calls = len(rec.logits)
    log(f"phase n: EP (moe_impl='ep', 1 x 1 NCCL mesh): prompt {S}: {batch} x {S} tokens, "
        f"{new} new, drop-free: prefill {res.prefill_s:.6f} s (the dispatch's "
        f"{dispatch['prefill_s']:.6f} s on the same prompt), {res.steps - 1} decode steps in "
        f"{res.decode_s:.6f} s ({res.decode_s / (res.steps - 1) * 1e3:.3f} ms a step; the "
        f"dispatch's {dispatch['decode_s']:.6f} s), flash_attention launches "
        f"{counts['flash_attention']}, all-to-alls {a2a} over {calls} model calls")
    check(counts["flash_attention"] == cfg.n_layers,
          f"phase n: the EP request launched flash_attention {counts['flash_attention']} "
          f"times, not {cfg.n_layers}")
    check(a2a == 2 * cfg.n_layers * calls, f"phase n: the EP request issued {a2a} all-to-alls, "
          f"not 2 a MoE layer call ({2 * cfg.n_layers * calls})")
    with ep_router():
        fails, summary = moe_teacher_force("n (EP)", free, params, prompt, res.tokens,
                                           rec.logits, rl.calls)
    torch.cuda.empty_cache()
    return {"prefill_s": res.prefill_s, "decode_s": res.decode_s, "all_to_all": a2a,
            "flash_launches": counts["flash_attention"], "teacher": summary, "fails": fails}


# ------------------------------------------------------------ (u) the mesh
U_PSUM_BYTES = 64 << 20   # compressed_psum's f32 input
_HOST_MESH: list = []


def host_mesh(device: str = "cuda"):
    """The card's 1 x 1 ``("data", "model")`` mesh over NCCL (world size 1):
    phase (u) builds it, and (m), (n) and (q) reuse it or, run alone, build
    it themselves."""
    from repro_torch.launch.mesh import make_host_mesh

    if not _HOST_MESH:
        _HOST_MESH.append(make_host_mesh(device))
    return _HOST_MESH[0]


def leaf_bytes(t):
    import torch

    return t.detach().reshape(-1).view(torch.uint8)


def drive_mesh(root: Path, counters: Counters, device: str = "cuda") -> dict:
    """Phase (u): the 1 x 1 NCCL mesh (its backend and NCCL's version);
    ``compressed_psum`` over "data" on a 64 MiB f32 tensor, bit-equal to
    ``quant_dequant`` (the sum of one rank), both timed; a small train state
    (reduced Phi-3.5-MoE's params under ``moe_impl="ep"`` and its AdamW
    moments) committed and restored plain and with ``shardings=tree_spec(...)``
    of its ``param_axes`` onto the mesh, every DTensor's local tensor equal
    to the plain restore's leaf bit for bit."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import VersionedCheckpointManager
    from repro_torch.configs import ARCHS
    from repro_torch.distributed.compression import compressed_psum, quant_dequant
    from repro_torch.distributed.sharding import P, NamedSharding, logical_sharding, tree_spec
    from repro_torch.models import get_model
    from repro_torch.models import transformer as tf
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.tree import tree_paths

    t0 = time.perf_counter()
    mesh = host_mesh(device)
    mesh_s = time.perf_counter() - t0
    backend, want = dist.get_backend(), "nccl" if device == "cuda" else "gloo"
    nccl = torch.cuda.nccl.version() if device == "cuda" else "none"
    nccl = ".".join(map(str, nccl)) if isinstance(nccl, tuple) else str(nccl)
    log(f"phase u: mesh {mesh} in {mesh_s:.3f} s; backend {backend}, world size "
        f"{dist.get_world_size()}, NCCL {nccl}")
    check(backend == want and dist.get_world_size() == 1 and mesh.device_type == device,
          f"phase u: the mesh runs {backend} on {mesh.device_type} at world size "
          f"{dist.get_world_size()}, not {want} on {device} at 1")

    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    x = torch.randn(U_PSUM_BYTES // 4, generator=gen, device=device)
    with logical_sharding(mesh):
        got = compressed_psum(x, "data")
        want = quant_dequant(x)
        check(torch.equal(leaf_bytes(got), leaf_bytes(want)),
              "phase u: compressed_psum over 'data' differs from quant_dequant")
        psum_ms = cuda_ms(lambda: compressed_psum(x, "data"), iters=10)
    qd_ms = cuda_ms(lambda: quant_dequant(x), iters=10)
    # compressed_psum's least work: read x once, write the result once
    log(f"phase u: compressed_psum over 'data' of {U_PSUM_BYTES >> 20} MiB f32: bit-equal to "
        f"quant_dequant; {psum_ms:.6f} ms a call (CUDA events, 10 after 3), quant_dequant "
        f"{qd_ms:.6f} ms, bound {bound_ms(2 * U_PSUM_BYTES):.6f} ms (bytes: one read, one "
        "write, at 3.35 TB/s)")
    del x, got, want

    cfg = dataclasses.replace(ARCHS[PHI_ARCH].reduced(), moe_impl="ep")
    bundle = get_model(cfg)
    params = bundle.init(torch.Generator(device=device).manual_seed(SEED), device=device)
    state = {"params": params, "opt": init_opt_state(params)}
    moments = tf.param_shapes(cfg, torch.float32)
    template = {"params": tf.param_shapes(cfg),
                "opt": {"mu": moments, "nu": moments, "step": ((), torch.int32)}}
    axes = bundle.param_axes(template["params"])
    shardings = {"params": tree_spec(axes, template["params"], mesh=mesh),
                 "opt": {"mu": tree_spec(axes, moments, mesh=mesh),
                         "nu": tree_spec(axes, moments, mesh=mesh),
                         "step": NamedSharding(mesh, P())}}
    counters.zero()
    mgr = VersionedCheckpointManager(root / "u_ckpt", device=device)
    try:
        mgr.save(0, state, blocking=True)
        t0 = time.perf_counter()
        plain = mgr.restore(template)
        sync(device)
        plain_s = time.perf_counter() - t0
        sharded_s = []
        for _ in range(2):  # the first pays DTensor's one-time setup
            t0 = time.perf_counter()
            sharded = mgr.restore(template, shardings=shardings)
            sync(device)
            sharded_s.append(time.perf_counter() - t0)
    finally:
        mgr.close()
    counters.read("phase u (commit)", ())
    leaves = list(zip(tree_paths(plain), tree_paths(sharded)))
    bad = [k for (k, a), (_, b) in leaves
           if not (b.placements and torch.equal(leaf_bytes(b.to_local()), leaf_bytes(a)))]
    n_bytes = sum(a.numel() * a.element_size() for (_, a), _ in leaves)
    log(f"phase u: a train state of {len(leaves)} leaves ({n_bytes / 2**20:.3f} MiB: reduced "
        f"{cfg.name}'s params and moments) committed and restored on the card: plain "
        f"{plain_s:.6f} s, with shardings onto the mesh {sharded_s[0]:.6f} s (the process's "
        f"first DTensors), again {sharded_s[1]:.6f} s; every DTensor's "
        f"local tensor bit-equal to the plain leaf: {not bad}")
    check(not bad, f"phase u: sharded restores differ from the plain: {bad[:4]}")
    return {"psum_ms": psum_ms, "quant_dequant_ms": qd_ms, "restore_s": plain_s,
            "sharded_restore_s": sharded_s}


# ---------------------------------------------------- (o) recurrent families
RG_ARCH = "recurrentgemma-9b"
RG_PROMPTS = (2048, 3072)   # = W, and 3072 % 2048 = 1024: a prompt that wraps the ring
RWKV_ARCH = "rwkv6-3b"
RWKV_PROMPTS = ((1024, "scan"), (2048, "chunked"))
REC_BATCH = 4
REC_NEW = 16
REC_WARMUP = 128   # a warm-up request's prompt, a multiple of the WKV chunk
SCAN_TOL = 1e-5    # the RG-LRU scan against an f64 recurrence, ||d|| / ||ref||
WKV_TOL = 1e-4     # the chunked WKV against the scan, ||d|| / ||scan||
# The WKV forms' prefill logits, ||chunked - scan|| / ||scan|| a row.  The
# forms agree to WKV_TOL at a layer; through 32 bf16 layers that difference
# reaches 0.030436 of the logits' norm, and the chunked form with a planted
# fault (the bonus term u left out, :func:`no_bonus`) 0.118830 (on an NVIDIA
# H100 80GB HBM3, 700 W).  The limit is their geometric mean, a factor of 2
# of room each side; the phase fails if the planted fault lands under it.
FORMS_TOL = 0.06


def recurrent_model(name: str, n_layers: int = 0, phase: str = "o"):
    """The published config of ``name`` at its full width and depth (or cut
    to ``n_layers``), its parameters drawn on the card from a seeded
    generator; the tree must number ``count_params``, plus the twelve
    D-vectors a layer it leaves out for RWKV-6 (ROADMAP Queue 3)."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models import count_params, get_model

    cfg = ARCHS[name]
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t0 = time.perf_counter()
    params = get_model(cfg).init(torch.Generator(device="cuda").manual_seed(SEED),
                                 device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in _leaves(params))
    n_norms = sum(t.numel() for name_, t in _leaves(params) if "norm" in name_)
    pad = (cfg.padded_vocab - cfg.vocab) * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    left_out = 12 * cfg.d_model * cfg.n_layers if "rwkv" in cfg.blocks() else 0
    full = ARCHS[name].n_layers
    depth = (f"widths, depth cut from {full} to {cfg.n_layers} layers (" if cfg.n_layers != full
             else f"widths and depth ({cfg.n_layers} layers, ")
    log(f"phase {phase}: {cfg.name} at its published {depth}pattern "
        f"{'/'.join(cfg.layer_pattern)}, d {cfg.d_model}, {cfg.n_heads} heads, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}"
        + (f", lru width {cfg.lru_width}, window {cfg.attn_window}, {cfg.n_kv_heads} KV "
           f"head of {cfg.resolved_head_dim}" if cfg.lru_width else
           f", heads of {cfg.rwkv_head_dim}, LoRA ranks {cfg.rwkv_shift_lora}/"
           f"{cfg.rwkv_decay_lora}") +
        f"): {n_params} parameters ({n_params - n_norms} but the norm scales; count_params "
        f"{count_params(cfg)} + {left_out} left out), {n_params * 2 / 1e9:.3f} GB bf16, drawn "
        f"on the card in {time.perf_counter() - t0:.3f} s")
    check(n_params - n_norms == count_params(cfg) + pad + left_out,
          f"phase {phase}: {n_params - n_norms} parameters against count_params "
          f"{count_params(cfg)} + {pad} padding + {left_out} left out")
    return cfg, params


class Capture:
    """While active, keeps the arguments of the first call of ``module.name``
    (as given) and lets every call through."""

    def __init__(self, module, name: str):
        self.module, self.name, self.args = module, name, None

    def __enter__(self):
        self.fn = getattr(self.module, self.name)

        def wrapped(*args, **kw):
            if self.args is None:
                self.args = args
            return self.fn(*args, **kw)

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


class Swap:
    """While active, ``recurrent.<name>`` is ``make(the function it
    replaces)``."""

    def __init__(self, name: str, make):
        self.name, self.make = name, make

    def __enter__(self):
        from repro_torch.models import recurrent

        self.fn = getattr(recurrent, self.name)
        setattr(recurrent, self.name, self.make(self.fn))
        return self

    def __exit__(self, *exc):
        from repro_torch.models import recurrent

        setattr(recurrent, self.name, self.fn)


def _sequential_scan(_):
    """The RG-LRU's recurrence one step at a time in f32 (h_t = a_t *
    h_{t-1} + bx_t, as a decode step runs it) in place of the associative
    scan: a second route to the same logits."""
    import torch

    def scan(a, bx, h0):
        h, hs = h0, []
        for t in range(a.shape[1]):
            h = a[:, t] * h + bx[:, t]
            hs.append(h)
        return torch.stack(hs, dim=1), h

    return scan


def sequential_scan() -> Swap:
    return Swap("_rglru_scan", _sequential_scan)


def no_bonus() -> Swap:
    """A planted fault: the chunked WKV with its bonus term u (each token's
    own k v) left out."""
    import torch

    return Swap("_wkv_chunked", lambda fn: lambda r, k, v, w, u, s0:
                fn(r, k, v, w, torch.zeros_like(u), s0))


def norm_ratio(got, want) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm())


def rglru_scan_check(a, bx, h0) -> dict:
    """The associative scan on a real layer input against the recurrence
    run sequentially in f64."""
    import torch

    from repro_torch.models import recurrent

    hh, last = recurrent._rglru_scan(a, bx, h0)
    h, ref = h0.double(), []
    a64, bx64 = a.double(), bx.double()
    for t in range(a.shape[1]):
        h = a64[:, t] * h + bx64[:, t]
        ref.append(h)
    ref = torch.stack(ref, dim=1)
    out = {"max_abs": float((hh.double() - ref).abs().max()), "norm_ratio": norm_ratio(hh, ref),
           "last_max_abs": float((last.double() - ref[:, -1]).abs().max())}
    log(f"phase o: the RG-LRU scan on layer 0's input {tuple(a.shape)} against a sequential f64 "
        f"recurrence: max abs {out['max_abs']:.9f}, ||d|| / ||ref|| {out['norm_ratio']:.3e}, "
        f"last state max abs {out['last_max_abs']:.9f} (a in [{float(a.min()):.6f}, "
        f"{float(a.max()):.6f}])")
    check(out["norm_ratio"] <= SCAN_TOL, f"phase o: the RG-LRU scan is {out['norm_ratio']} of "
          f"the f64 recurrence's norm from it (limit {SCAN_TOL})")
    return out


def wkv_forms_check(r, k, v, w, u, s0) -> dict:
    """The chunked WKV on a real layer input against the sequential scan."""
    from repro_torch.models import recurrent

    out_c, s_c = recurrent._wkv_chunked(r, k, v, w, u, s0)
    out_s, s_s = recurrent._wkv_scan(r, k, v, w, u, s0)
    res = {"max_abs": float((out_c - out_s).abs().max()), "norm_ratio": norm_ratio(out_c, out_s),
           "state_max_abs": float((s_c - s_s).abs().max()),
           "state_norm_ratio": norm_ratio(s_c, s_s)}
    log(f"phase o: the chunked WKV on layer 0's input {tuple(r.shape)} against the sequential "
        f"scan: out max abs {res['max_abs']:.9f}, ||d|| / ||scan|| {res['norm_ratio']:.3e}; last "
        f"state max abs {res['state_max_abs']:.9f}, ||d|| / ||scan|| "
        f"{res['state_norm_ratio']:.3e} (decay in [{float(w.min()):.6f}, {float(w.max()):.6f}])")
    check(max(res["norm_ratio"], res["state_norm_ratio"]) <= WKV_TOL,
          f"phase o: the WKV forms differ by {res} (limit {WKV_TOL} of the norm)")
    return res


def ring_check(cfg, p, x, S: int) -> dict:
    """One windowed attention layer at its real input ``x`` (B, S + n, D):
    a prefill of S tokens, then n decode steps.  After the prefill and after
    each step, every position q of the window (the last W up to the newest)
    must sit at ring slot q % W, bit for bit against its k and v projected
    as the call that wrote it projects them (the prompt's at once, each
    decoded token alone): a wrong write slot or eviction fails it at any W.
    Each step's output is printed beside the windowed forward's, and the
    first step's also beside the same step on the ring laid out as the JAX
    package's prefill lays it (the last W keys from slot 0): at W = 2048 one
    misplaced key hides in the output's rounding, so those gaps are read,
    not held."""
    import torch

    from repro_torch.models import attention

    B, n, W = x.shape[0], x.shape[1], cfg.attn_window
    cache = attention.gqa_init_cache(cfg, B, n, window=W, device=x.device)
    attention.gqa_prefill(cfg, p, x[:, :S], cache, window=W)
    _, k, v = attention.gqa_project_qkv(cfg, p, x[:, :S], torch.arange(S, device=x.device))
    keys, values = [k], [v]

    def held(last: int) -> bool:
        q = torch.arange(max(0, last + 1 - W), last + 1, device=x.device)
        kk, vv = torch.cat(keys, 1), torch.cat(values, 1)
        return (torch.equal(cache["k"][:, q % W], kk[:, q])
                and torch.equal(cache["v"][:, q % W], vv[:, q]))

    fwd = attention.gqa_forward(cfg, p, x, window=W)[:, S:].float()
    shifted = {name: torch.roll(t, -(S % W), dims=1) for name, t in cache.items()}
    ref_layout = attention.gqa_decode(cfg, p, x[:, S:S + 1], shifted, S, window=W)[0][:, 0]
    ref_gap = float((ref_layout.float() - fwd[:, 0]).abs().max())
    wrong = [] if held(S - 1) else [S - 1]
    gaps = []
    for pos in range(S, n):
        out = attention.gqa_decode(cfg, p, x[:, pos:pos + 1], cache, pos, window=W)[0][:, 0]
        _, k, v = attention.gqa_project_qkv(
            cfg, p, x[:, pos:pos + 1], torch.full((1,), pos, dtype=torch.int64, device=x.device))
        keys.append(k)
        values.append(v)
        gaps.append(float((out.float() - fwd[:, pos - S]).abs().max()))
        if not held(pos):
            wrong.append(pos)
    scale = float(fwd.abs().max())
    log(f"phase o: ring of {W} after a {S}-token prefill and {n - S} decode steps: every "
        f"window's position q at slot q % W bit for bit "
        f"{'after each' if not wrong else f'NOT after positions {wrong}'}; decode outputs "
        f"against the windowed forward (max abs of the output {scale:.6f}) by step: "
        f"{' '.join(f'{g:.6f}' for g in gaps)}; the first step on the JAX package's layout "
        f"{ref_gap:.6f}")
    check(not wrong, f"phase o: the ring does not hold position q at slot q % W after the "
          f"writes up to positions {wrong}")
    return {"exact": not wrong, "steps": n - S, "scale": scale, "port": max(gaps),
            "reference_layout": ref_gap}


def decode_bytes(params, cache) -> tuple:
    """The bytes a decode step needs: every weight but the embedding table
    (it reads the batch's rows), each cache and state leaf read once, and
    the recurrent states (not the attention ring, one slot a step) written
    once.  Returns (bytes, weight bytes, cache bytes)."""
    weights = sum(t.numel() * t.element_size() for _, t in _leaves(
        {k: v for k, v in params.items() if k != "embed"}))
    read = written = 0
    for name, t in _leaves(cache):
        n = t.numel() * t.element_size()
        read += n
        written += 0 if name in ("k", "v") else n
    return weights + read + written, weights, read


def timed_recurrent_step(cfg, bundle, params, engine, tokens) -> dict:
    """After a prefill of ``tokens``, REC_NEW decode steps timed together
    (host clock, ending in a synchronisation), then one more under
    torch.profiler, beside the bytes a step needs."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    S = tokens.shape[1]
    cache = engine._cache0
    tok = tokens[:, -1:]
    with torch.no_grad():
        bundle.prefill(params, {"tokens": tokens}, cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(REC_NEW):
            bundle.decode_step(params, tok, cache, S + i)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / REC_NEW
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            bundle.decode_step(params, tok, cache, S + REC_NEW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    needed, weights, cache_bytes = decode_bytes(params, cache)
    for _, t in _leaves(cache):
        t.zero_()
    bound = needed / HBM_BYTES_PER_S
    log(f"phase o: {cfg.name}: {REC_NEW} timed decode steps after a {tokens.shape[0]} x {S} "
        f"prefill: {step_s * 1e3:.3f} ms a step; traced step (position {S + REC_NEW}): "
        f"{busy_share(prof, wall)}; kernel classes: {kernel_classes(prof)}. The bytes a step "
        f"needs: {needed / 1e9:.3f} GB ({weights / 1e9:.3f} GB of weights but the embedding "
        f"table, {cache_bytes / 1e9:.3f} GB of ring and state read, the states written), "
        f"{bound * 1e3:.3f} ms at 3.35 TB/s: a timed step is {step_s / bound:.2f}x that bound, "
        f"the traced one {wall / bound:.2f}x")
    return {"decode_step_s": step_s, "traced_step_s": wall, "needed_gb": needed / 1e9,
            "step_bound_s": bound}


def serve_recurrent(counters: "Counters", cfg, params, requests: list) -> dict:
    """Greedy requests of REC_BATCH prompts and REC_NEW new tokens through a
    ServeEngine (after a short warm-up), timed, each held against teacher
    forcing over two routes (:func:`hold_to_teacher`).  A request: its
    ``label``, prompt length ``S``, config ``cfg`` (route A's too), route
    B's context ``ctx`` and config ``cfg_b``, and the teachers' lengths
    ``len_a`` and ``len_b`` (padded where the chunked WKV needs it)."""
    import torch

    from repro_torch.models import get_model
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServeEngine

    rng = np.random.default_rng(SEED)
    max_len = max(r["S"] for r in requests) + REC_NEW
    out, fails = {}, []
    for r in requests:
        S, run_cfg, label = r["S"], r["cfg"], r["label"]
        rec = LogitLog(get_model(run_cfg))
        engine = ServeEngine(rec.bundle, params, max_len=max_len, batch=REC_BATCH, device="cuda")
        prompt = rng.integers(0, cfg.vocab, (REC_BATCH, S)).astype(np.int32)
        engine.generate({"tokens": prompt[:, :REC_WARMUP]}, max_new_tokens=2)
        rec.logits.clear()
        torch.cuda.reset_peak_memory_stats()
        counters.zero()
        res = engine.generate({"tokens": prompt}, max_new_tokens=REC_NEW)
        counts = counters.read(f"phase o ({label})", ())
        check(counts["flash_attention"] == 0, f"phase o: {label} launched flash_attention "
              f"{counts['flash_attention']} times")
        peak = torch.cuda.max_memory_allocated() / 2**30
        step_s = res.decode_s / (res.steps - 1)
        log(f"phase o: {label}: prefill of {REC_BATCH} x {S} tokens {res.prefill_s:.6f} s "
            f"({REC_BATCH * S / res.prefill_s:.1f} tok/s); {res.steps - 1} decode steps in "
            f"{res.decode_s:.6f} s ({step_s * 1e3:.3f} ms a step, {REC_BATCH / step_s:.1f} tok/s); "
            f"peak device memory {peak:.3f} GiB; flash_attention launches "
            f"{counts['flash_attention']}")

        full = torch.cat([torch.as_tensor(prompt, dtype=torch.int64),
                          torch.as_tensor(res.tokens[:, :-1], dtype=torch.int64)], 1).to("cuda")
        t0 = time.perf_counter()
        pre = teacher_logits(run_cfg, tf, params, full[:, :S], S, S)[:, 0]
        want = teacher_logits(run_cfg, tf, params, full, S, r["len_a"])
        with r["ctx"]():
            other = teacher_logits(r["cfg_b"], tf, params, full, S, r["len_b"])
        log(f"phase o: {label}: teachers over {full.shape[1]} tokens (route A at {r['len_a']}, "
            f"route B {r['route_b']} at {r['len_b']}) in {time.perf_counter() - t0:.3f} s")
        f, summary = hold_to_teacher("o", label, rec.logits, res.tokens, pre, want, other)
        fails += f
        out[label] = {
            "prefill_s": res.prefill_s, "decode_s": res.decode_s, "decode_step_s": step_s,
            "peak_gib": peak, "flash_launches": counts["flash_attention"], "teacher": summary,
            "prefill_logits": rec.logits[0], "route_b_prefill": other[:, 0], "prompt": prompt,
            "cfg": run_cfg}
        del engine
    check(not fails, "phase o: " + "; ".join(fails))
    return out


def forms_check(params, r: dict) -> dict:
    """The two WKV forms' prefill logits on one prompt: the chunked
    request's prefill against its scan-form teacher at the prompt's last
    position, within FORMS_TOL of the norm a row; and the chunked form with
    a planted fault (:func:`no_bonus`) on the same prompt, which must land
    above FORMS_TOL."""
    import torch

    from repro_torch.models import transformer as tf

    S = r["prompt"].shape[1]
    scan_pre, chunked_pre = r["route_b_prefill"], r["prefill_logits"]
    tokens = torch.as_tensor(r["prompt"], dtype=torch.int64, device="cuda")
    with no_bonus():
        fault_pre = teacher_logits(r["cfg"], tf, params, tokens, S, S)[:, 0]

    def rel(got) -> float:
        return float(((got - scan_pre).norm(dim=-1) / scan_pre.norm(dim=-1)).max())

    sound, fault = rel(chunked_pre), rel(fault_pre)
    ratio = float(((chunked_pre - scan_pre).abs() / (2e-2 + 2e-2 * scan_pre.abs())).max())
    log(f"phase o: the WKV forms' prefill logits on the {S}-token prompt: max abs "
        f"{float((chunked_pre - scan_pre).abs().max()):.6f} (allclose ratio {ratio:.4f} at "
        f"2e-2), ||chunked - scan|| / ||scan|| max {sound:.6f} a row; the chunked form with "
        f"the bonus term left out (a planted fault) {fault:.6f}; limit {FORMS_TOL}")
    check(sound <= FORMS_TOL, f"phase o: the WKV forms' prefill logits differ by {sound} of "
          "their norm")
    check(fault > FORMS_TOL, f"phase o: the planted fault moves the logits by only {fault} "
          f"of their norm, within the forms' limit {FORMS_TOL}")
    return {"norm_ratio": sound, "allclose_ratio": ratio, "planted_fault": fault}


def drive_recurrent_model(counters: "Counters", name: str) -> dict:
    """One model of phase (o)."""
    import contextlib
    import dataclasses

    import torch

    from repro_torch.models import get_model, recurrent
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServeEngine

    cfg, params = recurrent_model(name)
    rng = np.random.default_rng(SEED + 1)
    out = {}
    if name == RG_ARCH:
        S = max(RG_PROMPTS)
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (REC_BATCH, S + REC_NEW)),
                                 device="cuda")
        with torch.no_grad(), Capture(recurrent, "_rglru_scan") as scan, \
                Capture(tf.attn_lib, "gqa_forward") as attn:
            tf.forward_hidden(cfg, params, tokens)
        out["scan"] = rglru_scan_check(*scan.args)
        with torch.no_grad():
            out["ring"] = ring_check(cfg, attn.args[1], attn.args[2], S)
        del scan, attn
        requests = [dict(label=f"{cfg.name} prompt {P}", S=P, cfg=cfg, ctx=sequential_scan,
                         cfg_b=cfg, route_b="(the RG-LRU stepped sequentially)",
                         len_a=P + REC_NEW - 1, len_b=P + REC_NEW - 1) for P in RG_PROMPTS]
    else:
        forms = {impl: dataclasses.replace(cfg, rwkv_impl=impl) for impl in ("scan", "chunked")}
        S = max(P for P, _ in RWKV_PROMPTS)
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (REC_BATCH, S)), device="cuda")
        with torch.no_grad(), Capture(recurrent, "_wkv_chunked") as wkv:
            tf.forward_hidden(forms["chunked"], params, tokens)
        out["wkv"] = wkv_forms_check(*wkv.args)
        del wkv
        length = {"scan": lambda P: P + REC_NEW - 1,   # the chunked form: a multiple of 32
                  "chunked": lambda P: -(-(P + REC_NEW - 1) // recurrent.WKV_CHUNK)
                  * recurrent.WKV_CHUNK}
        other = {"scan": "chunked", "chunked": "scan"}
        requests = [dict(label=f"{cfg.name} ({impl}) prompt {P}", S=P, cfg=forms[impl],
                         ctx=contextlib.nullcontext, cfg_b=forms[other[impl]],
                         route_b=f"(the {other[impl]} WKV)", len_a=length[impl](P),
                         len_b=length[other[impl]](P)) for P, impl in RWKV_PROMPTS]
    served = serve_recurrent(counters, cfg, params, requests)
    out["requests"] = {label: {k: v for k, v in r.items()
                               if k not in ("prefill_logits", "route_b_prefill", "prompt", "cfg")}
                       for label, r in served.items()}
    if name == RWKV_ARCH:
        out["forms"] = forms_check(params, [r for r in served.values()
                                            if r["cfg"].rwkv_impl == "chunked"][0])
    # one traced decode step after a prefill of the last request's prompt
    last = list(served.values())[-1]
    S = last["prompt"].shape[1]
    bundle = get_model(last["cfg"])
    engine = ServeEngine(bundle, params, max_len=S + REC_NEW + 1, batch=REC_BATCH,
                         device="cuda")
    tokens = torch.as_tensor(last["prompt"], dtype=torch.int64, device="cuda")
    counters.zero()
    out["traced"] = timed_recurrent_step(cfg, bundle, params, engine, tokens)
    counters.read(f"phase o ({cfg.name}, traced step)", ())
    del params, engine
    torch.cuda.empty_cache()
    return out


def drive_recurrent(counters: "Counters") -> dict:
    """Phase (o): RecurrentGemma-9B (RG-LRU + sliding-window attention) and
    RWKV-6 3B at their published widths and full depth, each alone on the
    card."""
    return {name: drive_recurrent_model(counters, name) for name in (RG_ARCH, RWKV_ARCH)}


# ------------------------------------------------------ (p) enc-dec serving
ED_ARCH = "seamless-m4t-medium"
ED_BATCH = 8
ED_ENC_LEN = 1024          # the engine's enc_len: the rows of the cache's enc_out entry
ED_NEW = 32
# (S_enc, prompt): both on flash; the decoder's prefill on the chunked
# softmax; the encoder on the chunked softmax with frames shorter than
# enc_len
ED_REQUESTS = ((1024, 128), (1024, 100), (1000, 128))


def encdec_lm(frames):
    """The enc-dec model on ``frames`` as the module :func:`teacher_logits`
    takes: a decoder whose ``forward_hidden`` reads the frames' encoding
    (the padding tokens are causal in its self-attention, and its
    cross-attention reads the encoder only)."""
    from types import SimpleNamespace

    from repro_torch.models import encdec as ed
    from repro_torch.models import transformer as tf

    return SimpleNamespace(
        forward_hidden=lambda cfg, params, tokens: ed.forward_hidden_encdec(
            cfg, params, frames, tokens),
        lm_logits=tf.lm_logits)


def encdec_step_bytes(cfg, params, S_enc: int, pos: int) -> tuple:
    """The bytes a decode step at position ``pos`` needs: the decoder's
    weights and the LM head (not the encoder's, nor the embedding table, of
    which it reads the batch's rows), the self cache up to the position and
    the S_enc rows of the encoder output, each read once; and the operations
    of the cross K/V that every layer recomputes from the encoder output
    (ROADMAP Queue 3).  Returns (bytes, weight bytes, cross K/V FLOPs)."""
    weights = sum(t.numel() * t.element_size() for _, t in _leaves(
        {k: v for k, v in params.items() if k not in ("embed", "enc")}))
    kv_row = cfg.n_kv_heads * cfg.resolved_head_dim * 2
    cache = 2 * cfg.n_layers * ED_BATCH * (pos + 1) * kv_row
    enc_out = ED_BATCH * S_enc * cfg.d_model * 2
    cross_flops = 2 * 2 * ED_BATCH * S_enc * cfg.d_model * cfg.n_kv_heads \
        * cfg.resolved_head_dim * cfg.n_layers
    return weights + cache + enc_out, weights, cross_flops


def drive_encdec(counters: Counters) -> dict:
    """Phase (p): SeamlessM4T-medium at its published widths and full depth
    on the card: three greedy requests through a ServeEngine, each held
    against teacher forcing, with the flash launches counted; then one
    prefill and one decode step under torch.profiler."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models import count_params, get_model
    from repro_torch.serving import ServeEngine

    cfg = ARCHS[ED_ARCH]
    bundle = get_model(cfg)
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in _leaves(params))
    n_norms = sum(t.numel() for name, t in _leaves(params) if "norm" in name)
    pad = (cfg.padded_vocab - cfg.vocab) * cfg.d_model * 2   # embed and lm_head
    log(f"phase p: {cfg.name} at its published widths and depth ({cfg.enc_layers} encoder and "
        f"{cfg.n_layers} decoder layers, d {cfg.d_model}, {cfg.n_heads} heads over "
        f"{cfg.n_kv_heads} of {cfg.resolved_head_dim}, d_ff {cfg.d_ff} {cfg.mlp_kind}, vocab "
        f"{cfg.vocab}): {n_params} parameters ({n_params - n_norms} but the norm scales; "
        f"count_params {count_params(cfg)} + {pad} vocab padding), {n_params * 2 / 1e9:.3f} GB "
        f"bf16, drawn on the card in {time.perf_counter() - t0:.3f} s")
    check(n_params - n_norms == count_params(cfg) + pad,
          f"phase p: {n_params - n_norms} parameters against count_params {count_params(cfg)} "
          f"+ {pad} padding")

    rec = LogitLog(bundle)
    max_len = max(S for _, S in ED_REQUESTS) + ED_NEW
    engine = ServeEngine(rec.bundle, params, max_len=max_len, batch=ED_BATCH,
                         enc_len=ED_ENC_LEN, device="cuda")
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)

    def request(S_enc: int, S: int) -> dict:   # the stub frontend's frames, N(0, 1) bf16
        return {"frames": torch.randn((ED_BATCH, S_enc, cfg.d_model), generator=gen,
                                      device="cuda").to(torch.bfloat16),
                "tokens": rng.integers(0, cfg.vocab, (ED_BATCH, S)).astype(np.int32)}

    t0 = time.perf_counter()
    engine.generate(request(*ED_REQUESTS[0]), max_new_tokens=2)   # warm-up
    log(f"phase p: warm-up request in {time.perf_counter() - t0:.3f} s")
    out, fails = {}, []
    for S_enc, S in ED_REQUESTS:
        label = f"S_enc {S_enc} prompt {S}"
        batch = request(S_enc, S)
        rec.logits.clear()
        torch.cuda.reset_peak_memory_stats()
        counters.zero()
        res = engine.generate(batch, max_new_tokens=ED_NEW)
        want_launches = (cfg.enc_layers if S_enc % 128 == 0 else 0) + \
            (cfg.n_layers if S % 128 == 0 else 0)
        counts = counters.read(f"phase p ({label})", ("flash_attention",))
        check(counts["flash_attention"] == want_launches,
              f"phase p: {label} launched flash_attention {counts['flash_attention']} times, "
              f"not {want_launches}")
        check(res.tokens.shape == (ED_BATCH, ED_NEW), f"phase p: tokens {res.tokens.shape}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        step_s = res.decode_s / (res.steps - 1)
        log(f"phase p: {label}: prefill of {ED_BATCH} x {S_enc} frames and {ED_BATCH} x {S} "
            f"tokens {res.prefill_s:.6f} s; {res.steps - 1} decode steps in {res.decode_s:.6f} s "
            f"({step_s * 1e3:.3f} ms a step, {ED_BATCH / step_s:.1f} tok/s); peak device memory "
            f"{peak:.3f} GiB; flash_attention launches {counts['flash_attention']}")
        # two routes to the teacher's logits: the decoder's tokens as they
        # are (its self-attention on the chunked softmax) and padded to a
        # multiple of 128 (the flash kernel); the prefill is held against a
        # teacher over the prompt alone, the prefill's own arithmetic
        full = torch.cat([torch.as_tensor(batch["tokens"], dtype=torch.int64),
                          torch.as_tensor(res.tokens[:, :-1], dtype=torch.int64)], 1).to("cuda")
        n = full.shape[1]
        lm = encdec_lm(batch["frames"])
        pre = teacher_logits(cfg, lm, params, full[:, :S], S, S)[:, 0]
        want = teacher_logits(cfg, lm, params, full, S, n)
        other = teacher_logits(cfg, lm, params, full, S, -(-n // 128) * 128)
        f, summary = hold_to_teacher("p", label, rec.logits, res.tokens, pre, want, other)
        fails += f
        out[label] = {"prefill_s": res.prefill_s, "decode_s": res.decode_s,
                      "decode_step_s": step_s, "peak_gib": peak,
                      "flash_launches": counts["flash_attention"], "teacher": summary}

    # one prefill and one decode step under the profiler
    S_enc, S = ED_REQUESTS[0]
    batch = request(S_enc, S)
    inputs = {"frames": batch["frames"],
              "tokens": torch.as_tensor(batch["tokens"], dtype=torch.int64, device="cuda")}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    cache = engine._cache0
    torch.cuda.reset_peak_memory_stats()
    walls, ret = {}, None
    with torch.no_grad():
        for label, what in (("prefill", f"{ED_BATCH} x {S_enc} frames, {ED_BATCH} x {S} tokens"),
                            ("decode step", f"position {S}")):
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                if ret is None:
                    _, ret = bundle.prefill(params, inputs, cache)
                else:
                    bundle.decode_step(params, inputs["tokens"][:, -1:], ret, S)
                torch.cuda.synchronize()
                walls[label] = time.perf_counter() - t0
            log(f"phase p: traced {label} ({what}): {busy_share(prof, walls[label])}; "
                f"kernel classes: {kernel_classes(prof)}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    for _, t in _leaves(cache):
        t.zero_()
    needed, weights, cross_flops = encdec_step_bytes(cfg, params, S_enc, S)
    bound = needed / HBM_BYTES_PER_S
    cross_s = cross_flops / TENSOR_FLOPS_PER_S
    step_s = out[f"S_enc {S_enc} prompt {S}"]["decode_step_s"]
    log(f"phase p: the decode step needs {needed / 1e9:.3f} GB ({weights / 1e9:.3f} GB of "
        f"decoder and head weights, the self cache up to the position and the encoder output "
        f"read once): {bound * 1e3:.3f} ms at 3.35 TB/s; the cross K/V recomputed in every "
        f"layer is {cross_flops / 1e12:.4f} TFLOP, {cross_s * 1e3:.3f} ms at 989 TFLOP/s; the "
        f"traced step {walls['decode step'] * 1e3:.3f} ms ({walls['decode step'] / bound:.2f}x "
        f"the bytes bound), the engine's steps {step_s * 1e3:.3f} ms "
        f"({step_s / bound:.2f}x); peak device memory of the traced pair {peak:.3f} GiB")
    out["traced"] = {"prefill_s": walls["prefill"], "decode_step_s": walls["decode step"],
                     "needed_gb": needed / 1e9, "step_bound_s": bound,
                     "cross_kv_tflop": cross_flops / 1e12, "cross_kv_s": cross_s,
                     "peak_gib": peak}
    del params, engine, rec
    torch.cuda.empty_cache()
    check(not fails, "phase p: " + "; ".join(fails))
    return out


# ------------------------------------------------------------- (k) training
TRAIN_RUN = dict(arch="minicpm-2b", reduced=False, steps=5, seq_len=1024, global_batch=8,
                 save_every=0, schedule="wsd")
CE_RTOL = 1e-3  # chunked against unchunked CE of the same hidden states
# ... and their gradients with respect to those states, as a norm of the
# difference over the norm: both are bf16 (unit roundoff 2**-8 = 3.9e-3) and
# cuBLAS may pick another algorithm for a chunk than for the whole.  A chunk
# that took the wrong targets, or was counted twice, is off by O(1) here.
CE_GRAD_RTOL = 1e-2
ATTN_WEIGHTS = ("wq", "wk", "wv", "wo")


def forward_flops(cfg, batch: int, seq: int, capacity_slots: int = 0, enc_seq: int = 0) -> float:
    """Matmul operations of one forward pass, counted from the shapes: 2 x
    each weight x the tokens it multiplies, and attention's QK^T and PV over
    the (query, key) pairs a sequence needs: S(S+1)/2 causal, W(W+1)/2 + (S -
    W) W in a sliding window W (RecurrentGemma's attention layers), S x S_enc
    across (the enc-dec decoder's cross-attention) and S_enc^2 in the
    non-causal encoder.  Each layer's GQA or MLA attention (MLA's five
    projections, its QK^T at nd + rd and PV at vd), RG-LRU block (its two
    input branches and output projection; the width-4 conv and the scan are
    elementwise), RWKV-6 block (the five D x D projections, the token-shift
    and decay LoRAs, the WKV's r S and k^T v products, 2 x 2 x hd^2 a token
    and head, and the channel mix), its MLP (SwiGLU or GELU) or MoE layer
    (the f32 router, the shared expert per token, and the routed experts
    over all the dispatch's E x B x (C + 1) buffer rows, ``capacity_slots``
    = C + 1: the slots it computes, the overflow bin and empty slots
    included), with ``enc_seq`` the encoder stack over ``enc_seq`` frames and
    each decoder layer's cross-attention (its K/V projections over the
    frames), the LM head over the B x (S - 1) positions that have a target,
    and with an MTP head its projection (2D -> D), one dense block over S - 1
    positions and its head over B x (S - 2).  A train step needs 3 of them
    (the forward and the backward's two); the remat's recompute of every
    layer and CE chunk is a fourth, a choice of this implementation that the
    bound does not count.  All of it is counted at the bf16 tensor rate,
    though the WKV runs in f32: the bound stays a lower one."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    rd, nd, vd = cfg.qk_rope_head_dim, cfg.qk_nope_head_dim, cfg.v_head_dim
    W = cfg.attn_window

    def attention(kind, tokens, s, pairs=None):
        if pairs is None:
            pairs = batch * (s * (s + 1) / 2 if not W or s <= W
                             else W * (W + 1) / 2 + (s - W) * W)
        if kind == "mla":
            w = D * qr + qr * H * (nd + rd) + D * (kvr + rd) + kvr * H * (nd + vd) + H * vd * D
            return 2 * w * tokens + 2 * H * (nd + rd + vd) * pairs
        return 2 * (D * H * hd + 2 * D * KV * hd + H * hd * D) * tokens + 2 * 2 * H * hd * pairs

    def mlp(moe, tokens):
        if not moe:
            return 2 * (3 if cfg.mlp_kind == "swiglu" else 2) * D * cfg.d_ff * tokens
        rows = cfg.n_experts * batch * capacity_slots
        shared = 3 * D * cfg.expert_d_ff * cfg.n_shared_experts
        return (2 * D * cfg.n_experts * tokens + 2 * shared * tokens
                + 2 * 3 * D * cfg.expert_d_ff * rows)

    def rwkv(tokens):
        sl, dl, rh = cfg.rwkv_shift_lora, cfg.rwkv_decay_lora, cfg.rwkv_head_dim
        time_mix = 5 * D * D + 2 * 5 * D * sl + 2 * D * dl
        return (2 * (time_mix + 2 * D * cfg.d_ff + D * D) * tokens
                + 2 * 2 * (D // rh) * rh * rh * tokens)

    def block(i, kind, tokens):
        if kind == "rwkv":  # carries its own channel mix
            return rwkv(tokens)
        mixer = (2 * 3 * D * cfg.lru_width * tokens if kind == "rglru"
                 else attention(kind, tokens, seq))
        return mixer + mlp(cfg.layer_uses_moe(i), tokens)

    tokens = batch * seq
    total = sum(block(i, kind, tokens) for i, kind in enumerate(cfg.blocks()))
    total += 2 * D * cfg.padded_vocab * batch * (seq - 1)
    if enc_seq:
        enc_tokens = batch * enc_seq
        total += cfg.enc_layers * (attention("attn", enc_tokens, enc_seq, batch * enc_seq ** 2)
                                   + mlp(False, enc_tokens))
        total += cfg.n_layers * (2 * 2 * D * H * hd * tokens + 2 * 2 * D * KV * hd * enc_tokens
                                 + 2 * 2 * H * hd * batch * seq * enc_seq)
    if cfg.mtp:
        m = batch * (seq - 1)
        total += (2 * 2 * D * D * m + attention(cfg.blocks()[-1], m, seq - 1) + mlp(False, m)
                  + 2 * D * cfg.padded_vocab * batch * (seq - 2))
    return total


def ce_check(phase: str, head, params, hidden, targets, z_loss: float) -> str:
    """The chunked cross entropy against the unchunked on the same hidden
    states: the loss within ``CE_RTOL`` relative, and the gradient with
    respect to the hidden states within ``CE_GRAD_RTOL``."""
    import torch

    from repro_torch.training.train_loop import chunked_cross_entropy, cross_entropy

    h = hidden.detach().requires_grad_(True)
    chunked = chunked_cross_entropy(head, params, h, targets, z_loss)
    (g_chunked,) = torch.autograd.grad(chunked, h)
    full = cross_entropy(head(params, h), targets, z_loss)
    (g_full,) = torch.autograd.grad(full, h)
    chunked, full = chunked.item(), full.item()
    rel = abs(chunked - full) / abs(full)
    g_rel = float((g_chunked.float() - g_full.float()).norm() / g_full.float().norm())
    check(rel <= CE_RTOL, f"phase {phase}: chunked CE differs from the unchunked by {rel:.3e}")
    check(g_rel <= CE_GRAD_RTOL, f"phase {phase}: the chunked CE's gradient differs from the "
          f"unchunked's by {g_rel:.3e}")
    return (f"chunked CE {chunked:.9f}, unchunked {full:.9f}, relative difference {rel:.3e} "
            f"(tolerance {CE_RTOL}); their gradients with respect to the hidden states "
            f"differ by {g_rel:.3e} of the norm (tolerance {CE_GRAD_RTOL})")


def drive_training(root: Path, counters: Counters) -> dict:
    """Phase (k): ``train`` at full width and depth on the card (parameters
    drawn there from a seeded generator), then, off the counted run, one
    traced step, one backward on step 0's batch (every leaf's gradient
    present and finite, the attention projections' non-zero) and the
    chunked CE against the unchunked (:func:`ce_check`)."""
    import torch

    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.launch.train import RunConfig, run_model_config, train, train_config
    from repro_torch.models import count_params
    from repro_torch.training.train_loop import make_loss_fn, make_train_step
    from repro_torch.tree import tree_leaves, tree_paths

    run = RunConfig(**TRAIN_RUN, seed=SEED, ckpt_dir=str(root / "ckpt"))
    cfg = run_model_config(run)
    torch.cuda.reset_peak_memory_stats()
    counters.zero()
    t0 = time.perf_counter()
    out = train(run, device="cuda", log_every=10**9)  # the host reads the metrics after
    wall = time.perf_counter() - t0
    counts = counters.read("phase k (training)", ())
    check(counts["flash_attention"] == 0,
          f"phase k: training launched flash_attention {counts['flash_attention']} times")
    out["manager"].close()
    peak = torch.cuda.max_memory_allocated() / 2**30
    params = out["final_state"]["params"]
    n_params = sum(t.numel() for _, t in _leaves(params))
    n_norms = sum(t.numel() for name, t in _leaves(params) if "norm" in name)
    # count_params counts no norm scale and the vocabulary unpadded
    pad_rows = (cfg.padded_vocab - cfg.vocab) * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    check(n_params - n_norms - pad_rows == count_params(cfg),
          "phase k: parameter count differs from count_params")
    tokens = run.global_batch * run.seq_len
    fwd = forward_flops(cfg, run.global_batch, run.seq_len)
    flops = 3 * fwd
    bound_s = flops / TENSOR_FLOPS_PER_S
    for i, (loss, gn, lr, s) in enumerate(zip(out["losses"], out["grad_norms"], out["lrs"],
                                              out["step_s"])):
        check(np.isfinite(loss) and np.isfinite(gn),
              f"phase k: step {i}: loss {loss}, grad norm {gn}")
        log(f"phase k: step {i}: loss {loss:.6f}, grad norm {gn:.6f}, lr {lr:.6e}, "
            f"step wall {s:.6f} s{' (the first: allocations, cuBLAS plans)' if i == 0 else ''}")
    steady = out["step_s"][1:] or out["step_s"]
    mean = sum(steady) / len(steady)
    log(f"phase k: {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}: {n_params} "
        f"parameters; batch {run.global_batch} x {run.seq_len}; {len(out['losses'])} steps in "
        f"{wall:.3f} s (init included); steps 1-{len(out['step_s']) - 1}: mean {mean:.6f} s, "
        f"min {min(steady):.6f}, max {max(steady):.6f} ({tokens / mean:.1f} tokens/s); bound "
        f"{bound_s:.6f} s ({flops / 1e12:.3f} TFLOP over {TENSOR_FLOPS_PER_S / 1e12:.0f} "
        f"TFLOP/s; bound / step {bound_s / mean:.4f}); peak device memory {peak:.3f} GiB")
    log(f"phase k: the remat's recompute, outside the bound: {fwd / 1e12:.3f} TFLOP, "
        f"{fwd / TENSOR_FLOPS_PER_S:.6f} s at the peak rate (with it the step does "
        f"{4 * fwd / 1e12:.3f} TFLOP, {4 * fwd / TENSOR_FLOPS_PER_S / mean:.4f} of the peak)")

    # one more step under the profiler
    bundle, tcfg = out["bundle"], train_config(run)
    step_fn = make_train_step(bundle, tcfg)
    state, batch = out["final_state"], out["pipe"].next_batch()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    counters.zero()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    check(np.isfinite(metrics["loss"].item()), "phase k: traced step's loss is not finite")
    log(f"phase k: traced step: {busy_share(prof, traced, top=8)}")
    log(f"phase k: traced step by kernel class: {kernel_classes(prof)}")
    del prof, out, state, metrics, batch
    torch.cuda.empty_cache()

    # one backward on step 0's batch, and the chunked CE against the unchunked
    batch0 = SyntheticTokenPipeline(vocab=cfg.vocab, seq_len=run.seq_len,
                                    global_batch=run.global_batch, seed=run.seed,
                                    device="cuda").next_batch()
    names = [k for k, _ in tree_paths(params)]
    leaves = tree_leaves(params)
    loss = make_loss_fn(bundle, tcfg)(params, batch0)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    counts = counters.read("phase k (checks)", ())
    check(counts["flash_attention"] == 0, "phase k: the checks' backward launched flash")
    bad = [n for n, g in zip(names, grads) if g is None or not bool(torch.isfinite(g).all())]
    check(not bad, f"phase k: leaves without a finite gradient: {bad[:8]}")
    norms = {}
    for n, g in zip(names, grads):
        if n.rsplit("/", 1)[-1] in ATTN_WEIGHTS:
            norms[n] = float(g.float().norm())
            check(bool((g != 0).any()), f"phase k: the gradient of {n} is all zero")
    check(len(norms) == len(ATTN_WEIGHTS) * len(params["segments"]),
          f"phase k: attention projections seen: {sorted(norms)}")
    log("phase k: backward on step 0's batch: every leaf's gradient finite; attention "
        "projections' gradient norms " + ", ".join(f"{n} {v:.6e}" for n, v in norms.items()))
    del grads, loss
    with torch.no_grad():
        hidden, _ = bundle.train_hidden(params, batch0)
    log("phase k: step 0's batch: " + ce_check("k", bundle.head, params, hidden[:, :-1],
                                               batch0["tokens"][:, 1:], tcfg.z_loss))
    del params, hidden
    torch.cuda.empty_cache()
    return {"step_s": mean, "tokens_s": tokens / mean, "bound_s": bound_s, "peak_gib": peak}


# --------------------------------------------------- (l) checkpoint loop
LOOP_RUN = dict(arch="minicpm-2b", reduced=True, steps=60, seq_len=128, global_batch=8,
                save_every=10, max_restore_cost_s=30.0)
LOOP_PREEMPT_AT = 30
ACCUM_RUN = dict(arch="minitron-4b", reduced=True, steps=4, seq_len=128, global_batch=8,
                 save_every=0, grad_accum=2, compress_grads=True)
CORPUS_TOKENS = 1 << 22   # 16 MiB of int32 token ids
CORPUS_EDITS = 2          # cleaning passes, each rewriting tokens in 1% of the blocks


def preempt_at(at: int):
    """A preemption guard that reads preempted from its ``at``-th poll on
    (the train loop polls it once a step)."""
    from repro_torch.checkpoint import PreemptionGuard

    class PreemptAt(PreemptionGuard):
        def __init__(self):
            super().__init__()
            self.count = 0

        @property
        def preempted(self):
            self.count += 1
            return self.count >= at

    return PreemptAt()


def leaf_sha(x) -> str:
    """sha256 of a leaf's shape and bytes (a tensor, on any device, or numpy)."""
    import torch

    if isinstance(x, torch.Tensor):
        raw = x.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    else:
        raw = np.ascontiguousarray(x).tobytes()
    return hashlib.sha256(repr(tuple(x.shape)).encode() + raw).hexdigest()


def drive_checkpoint_loop(root: Path, counters: Counters) -> dict:
    """Phase (l): the versioned-checkpoint loop of examples/train_versioned.py
    on the card (preemption, emergency save, resume, SLA repack, a cold
    restore of every save against the sha256s of its host copy), a versioned
    corpus read through the pipeline, and a run with accumulation and
    compression."""
    import torch

    import repro_torch.checkpoint.versioned as ckv
    from repro_torch import obs
    from repro_torch.checkpoint import VersionedCheckpointManager
    from repro_torch.data import pipeline as dp
    from repro_torch.launch.train import RunConfig, run_model_config, state_template, train
    from repro_torch.store import VersionStore
    from repro_torch.tree import tree_paths

    saved, fed, copy_s = {}, [], []  # save step -> {path: sha256}; batch sha256s
    host_copy, next_tokens = ckv.host_copy, dp.SyntheticTokenPipeline.next_tokens

    def recording_copy(state):
        t0 = time.perf_counter()
        host = host_copy(state)
        copy_s.append(time.perf_counter() - t0)
        saved[int(host["data"]["step"]) - 1] = {k: leaf_sha(v) for k, v in tree_paths(host)}
        return host

    def recording_tokens(self):
        toks = next_tokens(self)
        fed.append(hashlib.sha256(toks.tobytes()).hexdigest())
        return toks

    ckpt = root / "ckpt"
    run = RunConfig(**LOOP_RUN, seed=SEED, ckpt_dir=str(ckpt))
    cfg = run_model_config(run)
    counters.zero()
    ckv.host_copy, dp.SyntheticTokenPipeline.next_tokens = recording_copy, recording_tokens
    try:
        with obs.tracing() as tracer:
            t0 = time.perf_counter()
            out1 = train(run, guard=preempt_at(LOOP_PREEMPT_AT), log_every=10**9, device="cuda")
            out1["manager"].close()
            out2 = train(run, log_every=10**9, device="cuda")
            train_s = time.perf_counter() - t0
            mgr = out2["manager"]
            mgr.wait()
            before = mgr.store.storage_bytes()
            last = mgr.store.versions[mgr.latest_vid()]
            t0 = time.perf_counter()
            stats = mgr.repack()
            repack_s = time.perf_counter() - t0
            check(mgr.last_repack_error is None and mgr.repack_errors == 0,
                  f"phase l: a repack failed: {mgr.last_repack_error!r}")
            mgr.close()
    finally:
        ckv.host_copy, dp.SyntheticTokenPipeline.next_tokens = host_copy, next_tokens
    check(out1["preempted"] and out1["steps_done"] == LOOP_PREEMPT_AT,
          f"phase l: preempted {out1['preempted']} after {out1['steps_done']} steps")
    losses = out1["losses"] + out2["losses"]
    check(len(losses) == run.steps and bool(np.isfinite(losses).all()),
          f"phase l: {len(losses)} losses, finite {np.isfinite(losses).all()}")
    check(losses[-1] < losses[0], f"phase l: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    ref = dp.SyntheticTokenPipeline(vocab=cfg.vocab, seq_len=run.seq_len,
                                    global_batch=run.global_batch, seed=SEED, device="cpu")
    want = [hashlib.sha256(next_tokens(ref).tobytes()).hexdigest() for _ in range(run.steps)]
    check(fed == want, "phase l: the trainer's batches differ from an uninterrupted "
          f"pipeline's ({sum(a != b for a, b in zip(fed, want))} of {len(want)})")
    opt = stats["optimize"]
    check(opt["problem"] == 6 and opt["backend"] == "torch",
          f"phase l: the repack ran {opt}, not Problem 6 on the card")
    check(stats["after"]["max_recreation_s"] <= run.max_restore_cost_s,
          f"phase l: max restore cost {stats['after']['max_recreation_s']} over θ")
    span_s = {}
    for sp in tracer.spans():
        span_s.setdefault(sp.name, []).append(sp.duration)
    commits = span_s.get("store.commit", [])

    # a cold restore of every save, from a freshly opened store
    cold = VersionedCheckpointManager(ckpt, device="cuda")
    check(sorted(cold.step_to_vid) == sorted(saved),
          f"phase l: steps {sorted(cold.step_to_vid)} in the store, {sorted(saved)} saved")
    template = state_template(cfg)
    restore_s = []
    for step in sorted(saved):
        t0 = time.perf_counter()
        got = cold.restore(template, step=step)
        torch.cuda.synchronize()
        restore_s.append(time.perf_counter() - t0)
        digests = {k: leaf_sha(v) for k, v in tree_paths(got)}
        check(digests == saved[step], f"phase l: step {step}: "
              f"{sum(digests.get(k) != v for k, v in saved[step].items())} leaves differ")
    max_cost = max(cold.restore_cost_s(s) for s in saved)
    cold.close()
    counters.read("phase l (checkpoint loop)", ("changed_block_mask", "mp_loop"))
    log(f"phase l: {cfg.name}, {run.steps} steps (preempted at {LOOP_PREEMPT_AT - 1}, resumed) in "
        f"{train_s:.3f} s, loss {losses[0]:.4f} -> {losses[-1]:.4f}; saves at steps "
        f"{sorted(saved)}; one save {last.raw_bytes} B raw, {last.stored_bytes} B stored "
        f"({'delta' if last.stored_base else 'whole'}); host copy {np.mean(copy_s):.6f} s, "
        f"commit (background) mean {np.mean(commits):.6f} s, max {max(commits):.6f} s over "
        f"{len(commits)}; repack (Problem 6, θ {run.max_restore_cost_s} s) {repack_s:.3f} s "
        f"(measure {sum(span_s.get('store.measure', [0])):.3f} s): {before} -> "
        f"{stats['after']['storage_bytes']} B stored, max restore cost "
        f"{stats['before']['max_recreation_s']:.6f} -> {stats['after']['max_recreation_s']:.6f}"
        f" s modelled ({max_cost:.6f} cold); cold restores of {len(saved)} saves, every leaf "
        f"bit-identical: mean {np.mean(restore_s):.6f} s, max {max(restore_s):.6f} s")

    # a versioned corpus: a root and cleaning passes, read cold through the pipeline
    rng = np.random.default_rng(SEED)
    corpus = rng.integers(0, cfg.vocab, CORPUS_TOKENS, dtype=np.int32)
    store = VersionStore(root / "corpus", device="cuda")
    vid = store.commit({"shard0": corpus.copy()})
    for _ in range(CORPUS_EDITS):
        blocks = corpus.size * 4 // BLOCK
        for b in rng.choice(blocks, max(1, blocks // 100), replace=False):
            corpus[b * BLOCK // 4] = rng.integers(0, cfg.vocab)
        vid = store.commit({"shard0": corpus.copy()}, parents=[vid])
    check(store.versions[vid].stored_base is not None, "phase l: the cleaning pass was "
          "stored whole, not as a delta")
    store.close()
    counters.zero()
    pipe = dp.VersionedDatasetPipeline(VersionStore(root / "corpus", device="cuda"), vid,
                                       seq_len=run.seq_len, global_batch=run.global_batch)
    check(np.array_equal(pipe.stream.cpu().numpy(), corpus), "phase l: the corpus differs")
    need = run.global_batch * (run.seq_len + 1)
    for i in range(3):
        tokens = pipe.next_batch()["tokens"].cpu().numpy()
        start = (i * need) % max(1, corpus.size - need)
        check(np.array_equal(tokens, corpus[start:start + run.global_batch * run.seq_len]
                             .reshape(run.global_batch, run.seq_len)),
              f"phase l: corpus batch {i} differs")
    counts = counters.read("phase l (versioned corpus)", ())
    check(counts["chain_delta_apply"] + counts["sparse_delta_apply"] > 0,
          "phase l: the corpus checkout launched no delta-apply kernel")

    # accumulation and compression
    counters.zero()
    acc = train(RunConfig(**ACCUM_RUN, seed=SEED, ckpt_dir=str(root / "accum")),
                log_every=10**9, device="cuda")
    acc["manager"].close()
    counters.read("phase l (accumulation)", ())
    check(len(acc["losses"]) == ACCUM_RUN["steps"] and bool(np.isfinite(acc["losses"]).all()),
          f"phase l: accumulation run losses {acc['losses']}")
    log(f"phase l: {ACCUM_RUN['arch']} reduced, grad_accum {ACCUM_RUN['grad_accum']}, "
        f"compressed grads: losses {', '.join(f'{x:.6f}' for x in acc['losses'])}")
    return {"repack_s": repack_s, "restore_s": restore_s, "commit_s": commits}


# ------------------------------------------ (q) training the MoE and MLA families
Q_STEPS = 5
Q_PHI = (2, 4, 2048)     # layers (of 32), batch, sequence
Q_DS = (3, 2, 1024)      # DeepSeek-V3's 3 dense MLA layers (of 61) and the MTP head
Q_LAYER_TOKENS = 512     # (q3): one full-width DeepSeek MoE layer, 1 x 512 tokens
Q_UNREACHED = 4          # (q3): experts whose router column is zeroed, so no route reaches them
STATE_BYTES = 12         # a param's train state: bf16 param and gradient, f32 mu and nu
# A layer's gradients (x, the f32 router, each expert or shared stack)
# against moe_block_plain's autograd gradients on the same input, at
# drop-free capacity: ||d|| / ||plain|| per leaf.  On an NVIDIA H100 80GB
# HBM3 (700 W) the sound readings are 0 (q1: Phi-3.5-MoE's layer, bit-equal)
# and at most 1.79e-3 (q3: DeepSeek's router); the planted fault (the route
# weights detached) reads 0.446 on x and 1.0 on the router.  The limit is
# MOE_TOL, a factor 11 over the one and 22 under the other.
Q_GRAD_TOL = MOE_TOL
Q_DRIVER_RUN = dict(arch="deepseek-v3-671b", reduced=True, steps=12, seq_len=128,
                    global_batch=8, save_every=4, max_restore_cost_s=30.0)
Q_DRIVER_PREEMPT_AT = 6


def grad_ratios(got: dict, want: dict) -> dict:
    return {k: float((got[k].float() - want[k].float()).norm() / want[k].float().norm())
            for k in want}


def layer_grads(cfg, p, x, cot, wrt, block=None) -> dict:
    """Gradients of ``sum(block(x) * cot)`` (f32) with respect to ``wrt``
    (names of ``p``, and ``"x"``); a leaf that the output does not reach
    gets zeros (where a planted fault cuts it off)."""
    import torch

    from repro_torch.models import moe

    leaves = {**p, "x": x}
    inputs = [leaves[n].detach().requires_grad_(True) for n in wrt]
    named = {**p, **dict(zip(wrt, inputs))}
    x_in = named.pop("x")
    y = (block or moe.moe_block)(cfg, named, x_in)
    out = (y.float() * cot.float()).sum()
    grads = torch.autograd.grad(out, inputs, allow_unused=True, materialize_grads=True)
    return dict(zip(wrt, grads))


def moe_grad_check(phase: str, cfg, p, x) -> dict:
    """One MoE layer's backward on a real layer input ``x`` at drop-free
    capacity: each leaf's gradient (x, the router, the expert stacks, the
    shared expert's) through ``moe_block`` against ``moe_block_plain``'s,
    within ``Q_GRAD_TOL`` of the norm; then the same with a planted fault
    (the route weights detached: the router's gradient lost), which must
    land above the limit."""
    import torch

    from repro_torch.models import moe

    free = drop_free(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    cot = torch.randn(x.shape, generator=gen, device="cuda").to(torch.bfloat16)
    wrt = ["x", *sorted(p)]
    t0 = time.perf_counter()
    got = layer_grads(free, p, x, cot, wrt)
    torch.cuda.synchronize()
    block_s = time.perf_counter() - t0
    want = layer_grads(free, p, x, cot, wrt, block=moe.moe_block_plain)
    ratios = grad_ratios(got, want)
    del got
    route = moe.route

    def detached(c, logits):
        top_w, top_e = route(c, logits)
        return top_w.detach(), top_e

    moe.route = detached
    try:
        faulty = grad_ratios(layer_grads(free, p, x, cot, wrt), want)
    finally:
        moe.route = route
    del want
    torch.cuda.empty_cache()
    worst = max(ratios.values())
    log(f"phase {phase}: moe_block's backward against moe_block_plain's on the first MoE "
        f"layer's input {tuple(x.shape)}, drop-free (C = {moe.capacity(free, x.shape[1])}): "
        f"||d|| / ||plain|| " + ", ".join(f"{k} {v:.6e}" for k, v in ratios.items())
        + f" (limit {Q_GRAD_TOL}); with the route weights detached (planted fault): "
        + ", ".join(f"{k} {v:.6e}" for k, v in faulty.items())
        + f"; the dispatch's forward and backward {block_s:.6f} s (one call)")
    check(worst <= Q_GRAD_TOL, f"phase {phase}: a layer gradient is {worst} of the plain's norm "
          f"(limit {Q_GRAD_TOL})")
    check(max(faulty.values()) > Q_GRAD_TOL, f"phase {phase}: the planted fault lands under the "
          f"limit {Q_GRAD_TOL}: {faulty}")
    return {"ratios": ratios, "fault": faulty}


def traced_step(counters: Counters, phase: str, step_fn, state, batch):
    """One more train step under torch.profiler: its wall, the device's busy
    share and the top kernels, and the device time by kernel class."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    counters.zero()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    check(np.isfinite(m["loss"].item()), f"phase {phase}: the traced step's loss is not finite")
    log(f"phase {phase}: traced step: {busy_share(prof, traced, top=8)}")
    log(f"phase {phase}: traced step by kernel class: {kernel_classes(prof)}")
    return state


def train_cut_model(counters: Counters, phase: str, name: str, n_layers: int, batch: int,
                    seq: int) -> dict:
    """``make_train_step`` at the published widths of ``name`` cut to
    ``n_layers``: ``Q_STEPS`` steps of ``batch`` x ``seq`` synthetic tokens
    (the WSD schedule, as phase (k)), each step's wall on CUDA events, then a
    traced step, one backward on a fresh batch (every leaf's gradient present
    and finite; the attention, MoE and MTP leaves non-zero) and the chunked
    CE against the unchunked.  Every MoE layer's recompute in the backward
    pass must route as its forward did."""
    import torch

    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.launch.train import RunConfig, train_config
    from repro_torch.models import get_model, moe
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_loop import chunked_cross_entropy, make_loss_fn, make_train_step
    from repro_torch.tree import tree_leaves, tree_paths

    torch.cuda.reset_peak_memory_stats()
    cfg, params = moe_model(name, n_layers, phase)
    bundle = get_model(cfg)
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_moe = sum(cfg.layer_uses_moe(i) for i in range(cfg.n_layers))
    state = {"params": params, "opt": init_opt_state(params), "error_fb": None}
    tcfg = train_config(RunConfig(arch=name, steps=Q_STEPS, schedule="wsd"))
    step_fn = make_train_step(bundle, tcfg)
    pipe = SyntheticTokenPipeline(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=SEED,
                                  device="cuda")
    C = moe.capacity(cfg, seq) if n_moe else 0
    counters.zero()
    marks, metrics, routes = [cuda_event()], [], []
    for _ in range(Q_STEPS):
        tokens = pipe.next_batch()
        with RouteLog() as rl:
            state, m = step_fn(state, tokens)
        marks.append(cuda_event())
        metrics.append(m)
        routes.append(rl.calls)
    torch.cuda.synchronize()
    counts = counters.read(f"phase {phase} (training)", ())
    check(counts["flash_attention"] == 0,
          f"phase {phase}: training launched flash_attention {counts['flash_attention']} times")
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_s = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
    dropped = []
    for i, calls in enumerate(routes):
        check(len(calls) == 2 * n_moe, f"phase {phase}: step {i} routed {len(calls)} times, "
              f"not twice in each of {n_moe} MoE layers (forward, recompute)")
        same = all(torch.equal(calls[j], calls[2 * n_moe - 1 - j]) for j in range(n_moe))
        check(same, f"phase {phase}: step {i}: a layer's recompute chose other experts than "
              "its forward")
        if n_moe:
            pos = [moe.positions(e, cfg.n_experts) for e in calls[:n_moe]]
            dropped.append(float(sum(int((q >= C).sum()) for q in pos)
                                 / sum(q.numel() for q in pos)))
    for i, (m, s) in enumerate(zip(metrics, step_s)):
        loss, gn = m["loss"].item(), m["grad_norm"].item()
        check(np.isfinite(loss) and np.isfinite(gn), f"phase {phase}: step {i}: loss {loss}, "
              f"grad norm {gn}")
        log(f"phase {phase}: step {i}: loss {loss:.6f}, grad norm {gn:.6f}, lr "
            f"{m['lr'].item():.6e}, step wall {s:.6f} s"
            + (f", routes dropped {dropped[i]:.6f}" if n_moe else "")
            + (" (the first: allocations, cuBLAS plans)" if i == 0 else ""))
    steady = step_s[1:]
    mean = sum(steady) / len(steady)
    fwd = forward_flops(cfg, batch, seq, C + 1)
    bound_s = 3 * fwd / TENSOR_FLOPS_PER_S
    log(f"phase {phase}: {cfg.name}, {cfg.n_layers} layers: {n_params} parameters, train state "
        f"{n_params * STATE_BYTES / 1e9:.1f} GB ({STATE_BYTES} bytes a parameter); batch {batch} "
        f"x {seq}"
        + (f" at cf {cfg.capacity_factor} (C = {C}, {n_moe} MoE layers)" if n_moe else "")
        + f"; steps 1-{Q_STEPS - 1}: mean {mean:.6f} s, min {min(steady):.6f}, max "
        f"{max(steady):.6f} ({batch * seq / mean:.1f} tokens/s); bound {bound_s:.6f} s "
        f"({3 * fwd / 1e12:.3f} TFLOP over {TENSOR_FLOPS_PER_S / 1e12:.0f} TFLOP/s; bound / "
        f"step {bound_s / mean:.4f}); the remat's recompute, outside the bound, "
        f"{fwd / 1e12:.3f} TFLOP; peak device memory {peak:.3f} GiB")

    state = traced_step(counters, phase, step_fn, state, pipe.next_batch())

    # one backward on a fresh batch; the loss's parts; the chunked CE
    tokens = pipe.next_batch()
    params = state["params"]
    names = [k for k, _ in tree_paths(params)]
    loss_fn = make_loss_fn(bundle, tcfg)
    loss = loss_fn(params, tokens)
    grads = torch.autograd.grad(loss, tree_leaves(params), allow_unused=True)
    counts = counters.read(f"phase {phase} (checks)", ())
    check(counts["flash_attention"] == 0, f"phase {phase}: the checks' backward launched flash")
    bad = [n for n, g in zip(names, grads) if g is None or not bool(torch.isfinite(g).all())]
    check(not bad, f"phase {phase}: leaves without a finite gradient: {bad[:8]}")
    attn = {"wq", "wk", "wv", "wo", "wq_a", "wq_b", "wkv_a", "wkv_b", "router", "w_gate", "w_up",
            "w_down", "proj"}
    zero = [n for n, g in zip(names, grads)
            if (n.rsplit("/", 1)[-1] in attn or n.startswith("mtp/")) and not bool((g != 0).any())]
    check(not zero, f"phase {phase}: all-zero gradients: {zero}")
    log(f"phase {phase}: backward on a fresh batch: all {len(names)} leaves' gradients finite; "
        "gradient norms " + ", ".join(f"{n} {float(g.float().norm()):.6e}"
                                      for n, g in zip(names, grads)
                                      if n.startswith("mtp/") or "moe/" in n or "wq" in n))
    del grads, loss
    with torch.no_grad():
        hidden, aux = bundle.train_hidden(params, tokens)
        t = tokens["tokens"]
        main = chunked_cross_entropy(bundle.head, params, hidden[:, :-1], t[:, 1:], tcfg.z_loss)
        total = loss_fn(params, tokens)
    out = {"step_s": mean, "tokens_s": batch * seq / mean, "bound_s": bound_s, "peak_gib": peak,
           "dropped": dropped, "n_params": n_params}
    if "mtp_hidden" in aux:
        with torch.no_grad():
            mtp = chunked_cross_entropy(bundle.head, params, aux["mtp_hidden"][:, :-1], t[:, 2:])
        want = main + tcfg.mtp_weight * mtp
        rel = abs(total.item() - want.item()) / abs(want.item())
        log(f"phase {phase}: the loss on a fresh batch {total.item():.9f} = main CE "
            f"{main.item():.9f} + {tcfg.mtp_weight} x MTP CE {mtp.item():.9f} (relative "
            f"difference {rel:.3e})")
        check(rel <= 1e-6, f"phase {phase}: the loss is not the main CE plus the MTP term")
        log(f"phase {phase}: the MTP term's CE: " + ce_check(
            phase, bundle.head, params, aux["mtp_hidden"][:, :-1], t[:, 2:], 0.0))
        out["mtp_ce"], out["main_ce"] = mtp.item(), main.item()
    else:
        check(abs(total.item() - main.item()) <= 1e-6 * abs(main.item()),
              f"phase {phase}: the loss {total.item()} is not the main CE {main.item()}")
    log(f"phase {phase}: the main CE: " + ce_check(phase, bundle.head, params, hidden[:, :-1],
                                                   t[:, 1:], tcfg.z_loss))
    if n_moe:
        out["layer"] = moe_grad_check(phase, cfg, *moe_layer_input(drop_free(cfg), params,
                                                                   t[:1]))
    del state, params, hidden, aux, bundle, step_fn
    torch.cuda.empty_cache()
    return out


def cuda_event():
    """A timing event recorded on the current stream."""
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def deepseek_moe_layer(counters: Counters) -> dict:
    """(q3): one DeepSeek-V3 MoE layer at its published widths (256 experts
    top 8 of d_ff 2048, one shared expert, d 7168: 11.5 B parameters), one
    forward and backward of 1 x ``Q_LAYER_TOKENS`` seeded N(0, 1) bf16
    inputs at drop-free capacity with no optimizer; ``Q_UNREACHED`` experts'
    router columns are zeroed (a gate of 1 / sum, under every top-8 gate), so
    that no route reaches them.  The gradients of x, the router and the
    shared expert are held against ``moe_block_plain``'s (run with the expert
    stacks frozen: their gradients would not fit beside the dispatch's);
    every expert stack's gradient must be finite, exactly zero for each
    expert no route reached and non-zero for the rest."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf

    cfg = drop_free(ARCHS[DS_ARCH])
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    t0 = time.perf_counter()
    p = tf.block_init(cfg, "mla", True, gen, device="cuda")["moe"]
    p["router"][:, -Q_UNREACHED:] = 0
    x = torch.randn((1, Q_LAYER_TOKENS, cfg.d_model), generator=gen, device="cuda").to(
        torch.bfloat16)
    cot = torch.randn(x.shape, generator=gen, device="cuda").to(torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in p.values())
    with torch.no_grad():
        top_e = moe.route(cfg, moe.router_logits(p, x))[1]
    reached = torch.zeros(cfg.n_experts, dtype=torch.bool, device="cuda")
    reached[top_e.reshape(-1)] = True
    C = moe.capacity(cfg, Q_LAYER_TOKENS)
    check(not bool(reached[-Q_UNREACHED:].any()), "phase q3: a zeroed router column was chosen")
    counters.zero()
    experts = ["w_gate", "w_up", "w_down"]
    shared = ["shared_w_gate", "shared_w_up", "shared_w_down"]
    start = cuda_event()
    got = layer_grads(cfg, p, x, cot, ["x", "router", *shared, *experts])
    end = cuda_event()
    end.synchronize()
    wall = start.elapsed_time(end) / 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_expert = {}
    for n in experts:
        g = got.pop(n)
        check(bool(torch.isfinite(g).all()), f"phase q3: {n}'s gradient is not finite")
        per_expert[n] = g.flatten(1).abs().amax(1) > 0
        del g
    torch.cuda.empty_cache()
    for n, nonzero in per_expert.items():
        check(torch.equal(nonzero, reached), f"phase q3: {n}: the experts with a non-zero "
              f"gradient ({int(nonzero.sum())}) are not the {int(reached.sum())} reached")
    want = layer_grads(cfg, p, x, cot, ["x", "router", *shared], block=moe.moe_block_plain)
    counters.read("phase q3 (DeepSeek MoE layer)", ())
    ratios = grad_ratios(got, want)
    fwd = (2 * cfg.d_model * cfg.n_experts * Q_LAYER_TOKENS
           + 2 * 3 * cfg.d_model * cfg.expert_d_ff * (cfg.n_experts * (C + 1) + Q_LAYER_TOKENS))
    log(f"phase q3: {DS_ARCH}'s MoE layer at its published widths ({cfg.n_experts} experts top "
        f"{cfg.top_k} of d_ff {cfg.expert_d_ff}, {cfg.n_shared_experts} shared, d "
        f"{cfg.d_model}): {n_params} parameters; 1 x {Q_LAYER_TOKENS} tokens drop-free (C = {C}, "
        f"buffers ({cfg.n_experts}, 1, {C + 1}, {cfg.d_model})): the dispatch's forward and "
        f"backward {wall:.6f} s (CUDA events, one call, the first), bound "
        f"{3 * fwd / TENSOR_FLOPS_PER_S:.6f} s ({3 * fwd / 1e12:.3f} TFLOP); peak device memory "
        f"{peak:.3f} GiB; {int(reached.sum())} of {cfg.n_experts} experts reached (the "
        f"{Q_UNREACHED} zeroed not), each stack's gradient zero exactly where no route reached; "
        f"||d|| / ||plain|| " + ", ".join(f"{k} {v:.6e}" for k, v in ratios.items())
        + f" (limit {Q_GRAD_TOL})")
    check(max(ratios.values()) <= Q_GRAD_TOL, f"phase q3: gradients off the plain's: {ratios}")
    del got, want
    torch.cuda.empty_cache()
    ep = deepseek_moe_layer_ep(cfg, p, x, cot)
    del p, x, cot
    torch.cuda.empty_cache()
    return {"wall_s": wall, "peak_gib": peak, "ratios": ratios, "ep": ep}


def deepseek_moe_layer_ep(cfg, p, x, cot) -> dict:
    """(q3) again through ``moe_block_ep`` on the 1 x 1 NCCL mesh: the same
    layer, input and cotangent through the EP form's forward and backward.
    x's, the router's and the shared expert's gradients within
    ``Q_GRAD_TOL`` of ``moe_block_plain``'s over the EP form's own routes
    (:func:`ep_router`; the expert stacks frozen there); every expert stack's
    gradient finite, exactly zero for the experts no EP route reached (the
    ``Q_UNREACHED`` zeroed among them) and non-zero for the rest."""
    import dataclasses

    import torch

    from repro_torch.distributed.sharding import logical_sharding
    from repro_torch.models import moe, moe_ep

    ep_cfg = dataclasses.replace(cfg, moe_impl="ep")
    with torch.no_grad():
        top_e = moe.route(cfg, moe_ep.router_logits(p, x))[1]
    reached = torch.zeros(cfg.n_experts, dtype=torch.bool, device=x.device)
    reached[top_e.reshape(-1)] = True
    check(not bool(reached[-Q_UNREACHED:].any()),
          "phase q3 (EP): a zeroed router column was chosen")
    experts = ["w_gate", "w_up", "w_down"]
    small = ["x", "router", "shared_w_gate", "shared_w_up", "shared_w_down"]
    torch.cuda.reset_peak_memory_stats()
    a2a = moe_ep.all_to_all.calls
    with logical_sharding(host_mesh()):
        start = cuda_event()
        got = layer_grads(ep_cfg, p, x, cot, small + experts, block=moe_ep.moe_block_ep)
        end = cuda_event()
    end.synchronize()
    a2a = moe_ep.all_to_all.calls - a2a
    wall = start.elapsed_time(end) / 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    for n in experts:
        g = got.pop(n)
        check(bool(torch.isfinite(g).all()), f"phase q3 (EP): {n}'s gradient is not finite")
        nonzero = g.flatten(1).abs().amax(1) > 0
        del g
        check(torch.equal(nonzero, reached), f"phase q3 (EP): {n}: the experts with a non-zero "
              f"gradient ({int(nonzero.sum())}) are not the {int(reached.sum())} reached")
    torch.cuda.empty_cache()
    with ep_router():
        want = layer_grads(cfg, p, x, cot, small, block=moe.moe_block_plain)
    ratios = grad_ratios(got, want)
    log(f"phase q3 (EP): moe_block_ep on the 1 x 1 NCCL mesh, the same layer, input and "
        f"cotangent: forward and backward {wall:.6f} s (CUDA events, one call, the first), "
        f"{a2a} all-to-alls (forward and backward), peak device memory {peak:.3f} GiB; "
        f"{int(reached.sum())} of {cfg.n_experts} experts reached by the EP routes, each "
        f"stack's gradient zero exactly where none reached; ||d|| / ||plain over EP's routes|| "
        + ", ".join(f"{k} {v:.6e}" for k, v in ratios.items()) + f" (limit {Q_GRAD_TOL})")
    check(a2a == 4, f"phase q3 (EP): {a2a} all-to-alls, not 2 forward and 2 backward")
    check(max(ratios.values()) <= Q_GRAD_TOL,
          f"phase q3 (EP): gradients off the plain's: {ratios}")
    del got, want
    return {"wall_s": wall, "peak_gib": peak, "ratios": ratios}


def drive_reduced_driver(root: Path, counters: Counters, phase: str = "q4",
                         run_kw: dict = Q_DRIVER_RUN,
                         preempt: int = Q_DRIVER_PREEMPT_AT) -> dict:
    """(q4, r4): ``launch.train.train`` on a reduced config (DeepSeek-V3 in
    q4) with saves, a preemption (an emergency save) and a resume; every save
    restored cold from a freshly opened store must equal its host copy leaf
    for leaf (a sha256 each), every param the run trained in f32 (the
    routers; the recurrent blocks' vectors) restored as f32, the MTP head's
    subtree there where the config has one, and ``changed_block_mask`` must
    launch (each commit diffs against its parent)."""
    import torch

    import repro_torch.checkpoint.versioned as ckv
    from repro_torch.checkpoint import VersionedCheckpointManager
    from repro_torch.launch.train import RunConfig, run_model_config, state_template, train
    from repro_torch.tree import tree_paths

    saved = {}
    host_copy = ckv.host_copy

    def recording_copy(state):
        host = host_copy(state)
        saved[int(host["data"]["step"]) - 1] = {k: leaf_sha(v) for k, v in tree_paths(host)}
        return host

    ckpt = root / f"{run_kw['arch']}_ckpt"
    run = RunConfig(**run_kw, seed=SEED, ckpt_dir=str(ckpt))
    cfg = run_model_config(run)
    counters.zero()
    ckv.host_copy = recording_copy
    try:
        t0 = time.perf_counter()
        out1 = train(run, guard=preempt_at(preempt), log_every=10**9, device="cuda")
        out1["manager"].close()
        out2 = train(run, log_every=10**9, device="cuda")
        out2["manager"].close()
        train_s = time.perf_counter() - t0
    finally:
        ckv.host_copy = host_copy
    check(out1["preempted"] and out1["steps_done"] == preempt,
          f"phase {phase}: preempted {out1['preempted']} after {out1['steps_done']} steps")
    losses = out1["losses"] + out2["losses"]
    check(len(losses) == run.steps and bool(np.isfinite(losses).all()),
          f"phase {phase}: {len(losses)} losses, finite {np.isfinite(losses).all()}")
    cold = VersionedCheckpointManager(ckpt, device="cuda")
    check(sorted(cold.step_to_vid) == sorted(saved),
          f"phase {phase}: steps {sorted(cold.step_to_vid)} in the store, {sorted(saved)} saved")
    template = state_template(cfg)
    f32 = {"params/" + k for k, v in tree_paths(out2["final_state"]["params"])
           if v.dtype == torch.float32}
    check(bool(f32), f"phase {phase}: the run keeps no param in f32")
    keys = set()
    for step in sorted(saved):
        got = cold.restore(template, step=step)
        digests = {k: leaf_sha(v) for k, v in tree_paths(got)}
        keys |= set(digests)
        check(digests == saved[step], f"phase {phase}: step {step}: "
              f"{sum(digests.get(k) != v for k, v in saved[step].items())} leaves differ")
        wrong = [k for k, v in tree_paths(got) if k in f32 and v.dtype != torch.float32]
        check(not wrong, f"phase {phase}: step {step}: restored not as f32: {wrong[:4]}")
    cold.close()
    check(any(k.startswith("params/mtp/") for k in keys) == cfg.mtp,
          f"phase {phase}: MTP leaves restored: {not cfg.mtp}, the config's MTP head: {cfg.mtp}")
    counts = counters.read(f"phase {phase} (reduced driver)", ("changed_block_mask",))
    f32_names = sorted({k.rsplit("/", 1)[-1] for k in f32})
    log(f"phase {phase}: {cfg.name}, {run.steps} steps (preempted at {preempt - 1}, resumed) in "
        f"{train_s:.3f} s, loss {losses[0]:.4f} -> {losses[-1]:.4f}; saves at steps "
        f"{sorted(saved)}, each restored cold leaf for leaf ({len(keys)} leaves, the f32 "
        f"{', '.join(f32_names)}{' and the MTP head' if cfg.mtp else ''} among them); "
        f"changed_block_mask {counts['changed_block_mask']} launches, chain_delta_apply "
        f"{counts['chain_delta_apply']} (every save is stored whole, as in phase l)")
    return {"train_s": train_s, "launches": counts}


def drive_moe_training(root: Path, counters: Counters) -> dict:
    """Phase (q): (q1) Phi-3.5-MoE and (q2) DeepSeek-V3 trained at their
    published widths, depth cut; (q3) DeepSeek's full-width MoE layer's
    backward; (q4) the reduced driver with saves and a resume."""
    out = {"q1": train_cut_model(counters, "q1", PHI_ARCH, *Q_PHI)}
    out["q2"] = train_cut_model(counters, "q2", DS_ARCH, *Q_DS)
    out["q3"] = deepseek_moe_layer(counters)
    out["q4"] = drive_reduced_driver(root, counters)
    return out


# ------------------------------------------- (r) recurrent and enc-dec training
R_STEPS = 5
R_RG = (12, 2, 4096)     # RecurrentGemma-9B: layers (of 38: 4 (rglru, rglru, attn) units), batch, sequence
R_RWKV = (4, 2048)       # RWKV-6 3B at full depth, the chunked WKV: batch, sequence
R_RWKV_SCAN = (1, 512)   # then the config's default scan form: one step of batch x sequence
R_ED = (8, 1024, 1024)   # SeamlessM4T-medium at full depth: batch, frames, tokens
# (r1) The RG-LRU scan's gradients (a, bx, h0) on the first layer's real
# input against autograd through the recurrence run sequentially in f64,
# ||d|| / ||ref|| per input.  On an NVIDIA H100 80GB HBM3 (700 W) the sound
# readings are at most 4.900e-08 (a) and the planted fault (the h0 fold
# dropped) reads 0.5236 on a and 1.0 on h0: the limit sits 200x over the
# one and 50,000x under the other.
R_SCAN_GRAD_TOL = 1e-5
# (r2) The chunked WKV's gradients (r, k, v, w, u) on layer 0's real input
# against the scan form's, ||d|| / ||scan|| (the forward's WKV_TOL); the
# planted fault (the bonus dropped, :func:`no_bonus`) reads 1.0 on u.
R_WKV_GRAD_TOL = WKV_TOL
# (r2) Each leaf's gradient of the whole model in the chunked form against
# the scan form's, on the same weights and a 1 x 512 batch, ||d|| /
# ||scan||.  Through 32 bf16 layers at random init the gradients are far
# more sensitive than the forward (the forms' logits part by 0.03 in phase
# (o)): a relative f32 perturbation of 1e-4 of one layer's WKV output moves
# a leaf's gradient by up to 0.21 at two full-width layers (on the CPU).  On an
# NVIDIA H100 80GB HBM3 (700 W) the sound readings reach 0.4437 (decay_w2;
# median 0.190) and the planted fault 1.0 (u; median 0.346): the limit is
# their geometric mean, and the layer-level check above is the sharp one.
R_FORMS_GRAD_TOL = 0.67
R_DRIVER_ARCHS = (RG_ARCH, RWKV_ARCH)


def train_published(counters: Counters, phase: str, cfg, params, next_batch, batch: int,
                    seq: int, enc_seq: int = 0, nonzero=lambda name: False) -> dict:
    """``make_train_step`` on ``cfg`` (published widths) from ``params``:
    ``R_STEPS`` steps of ``next_batch()`` (the WSD schedule, as phases (k)
    and (q)), each step's wall on CUDA events, no flash launch; the bound
    (3 forwards, :func:`forward_flops`) and the peak device memory; then a
    traced step and one backward on a fresh batch, every leaf's gradient
    present and finite and non-zero where ``nonzero(path)``.  Returns the
    numbers, the state, the step and the loss function."""
    import torch

    from repro_torch.launch.train import RunConfig, train_config
    from repro_torch.models import get_model
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_loop import make_loss_fn, make_train_step
    from repro_torch.tree import tree_leaves, tree_paths

    bundle = get_model(cfg)
    n_params = sum(t.numel() for t in tree_leaves(params))
    state = {"params": params, "opt": init_opt_state(params), "error_fb": None}
    tcfg = train_config(RunConfig(arch=cfg.name, steps=R_STEPS, schedule="wsd"))
    step_fn = make_train_step(bundle, tcfg)
    counters.zero()
    marks, metrics = [cuda_event()], []
    for _ in range(R_STEPS):
        state, m = step_fn(state, next_batch())
        marks.append(cuda_event())
        metrics.append(m)
    torch.cuda.synchronize()
    counts = counters.read(f"phase {phase} (training)", ())
    check(counts["flash_attention"] == 0,
          f"phase {phase}: training launched flash_attention {counts['flash_attention']} times")
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_s = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
    for i, (m, s) in enumerate(zip(metrics, step_s)):
        loss, gn = m["loss"].item(), m["grad_norm"].item()
        check(np.isfinite(loss) and np.isfinite(gn), f"phase {phase}: step {i}: loss {loss}, "
              f"grad norm {gn}")
        log(f"phase {phase}: step {i}: loss {loss:.6f}, grad norm {gn:.6f}, lr "
            f"{m['lr'].item():.6e}, step wall {s:.6f} s"
            + (" (the first: allocations, cuBLAS plans)" if i == 0 else ""))
    steady = step_s[1:]
    mean = sum(steady) / len(steady)
    fwd = forward_flops(cfg, batch, seq, enc_seq=enc_seq)
    bound_s = 3 * fwd / TENSOR_FLOPS_PER_S
    shape = f"{batch} x ({enc_seq} frames, {seq} tokens)" if enc_seq else f"{batch} x {seq}"
    log(f"phase {phase}: {cfg.name}: {n_params} parameters, train state "
        f"{n_params * STATE_BYTES / 1e9:.1f} GB ({STATE_BYTES} bytes a parameter); batch {shape}; "
        f"steps 1-{R_STEPS - 1}: mean {mean:.6f} s, min {min(steady):.6f}, max "
        f"{max(steady):.6f} ({batch * seq / mean:.1f} tokens/s); bound {bound_s:.6f} s "
        f"({3 * fwd / 1e12:.3f} TFLOP over {TENSOR_FLOPS_PER_S / 1e12:.0f} TFLOP/s; bound / "
        f"step {bound_s / mean:.4f}); the remat's recompute, outside the bound, "
        f"{fwd / 1e12:.3f} TFLOP; peak device memory {peak:.3f} GiB")
    state = traced_step(counters, phase, step_fn, state, next_batch())

    fresh = next_batch()
    params = state["params"]
    names = [k for k, _ in tree_paths(params)]
    loss_fn = make_loss_fn(bundle, tcfg)
    grads = torch.autograd.grad(loss_fn(params, fresh), tree_leaves(params), allow_unused=True)
    counts = counters.read(f"phase {phase} (checks)", ())
    check(counts["flash_attention"] == 0, f"phase {phase}: the checks' backward launched flash")
    bad = [n for n, g in zip(names, grads) if g is None or not bool(torch.isfinite(g).all())]
    check(not bad, f"phase {phase}: leaves without a finite gradient: {bad[:8]}")
    zero = [n for n, g in zip(names, grads) if nonzero(n) and not bool((g != 0).any())]
    check(not zero, f"phase {phase}: all-zero gradients: {zero}")
    log(f"phase {phase}: backward on a fresh batch: all {len(names)} leaves' gradients finite, "
        f"{sum(map(nonzero, names))} checked non-zero; gradient norms "
        + ", ".join(f"{n} {float(g.float().norm()):.6e}" for n, g in zip(names, grads)
                    if nonzero(n)))
    del grads
    return {"step_s": mean, "tokens_s": batch * seq / mean, "bound_s": bound_s, "peak_gib": peak,
            "n_params": n_params, "state": state, "tcfg": tcfg}


def leaf_ratio(got, want) -> float:
    """``||got - want|| / ||want||``, summed in f64 over f32 slices of
    ``1 << 26`` elements: a stacked leaf of billions of elements never
    holds a widened copy of itself."""
    import torch

    d2 = w2 = 0.0
    for g, w in zip(torch.split(got.reshape(-1), 1 << 26), torch.split(want.reshape(-1), 1 << 26)):
        g, w = g.float(), w.float()
        d2 += float(torch.square(g - w).sum(dtype=torch.float64))
        w2 += float(torch.square(w).sum(dtype=torch.float64))
    return (d2 / w2) ** 0.5


def _scan_h0_dropped(_):
    """A planted fault: the RG-LRU scan without h0 folded into its first step."""
    from repro_torch.models import recurrent

    def scan(a, bx, h0):
        _, hh = recurrent._assoc_scan(a, bx)
        return hh, hh[:, -1]

    return scan


def rglru_grad_check(a, bx) -> dict:
    """(r1): the RG-LRU scan's backward on the first layer's real input
    (a, bx), from an N(0, 1) h0 so that the fold is exercised, against
    autograd through the recurrence run sequentially in f64, the one phase
    (o) holds the forward against; then with the h0 fold dropped (a planted
    fault), which must land above ``R_SCAN_GRAD_TOL``."""
    import torch

    from repro_torch.models import recurrent

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    h0 = torch.randn((a.shape[0], a.shape[2]), generator=gen, device="cuda")
    cot_h = torch.randn(a.shape, generator=gen, device="cuda")
    cot_last = torch.randn(h0.shape, generator=gen, device="cuda")

    def sequential(a_, bx_, h0_):
        h, hs = h0_, []
        for t in range(a_.shape[1]):
            h = a_[:, t] * h + bx_[:, t]
            hs.append(h)
        return torch.stack(hs, dim=1), h

    def grads(scan, dtype):
        ins = [t.detach().to(dtype).requires_grad_(True) for t in (a, bx, h0)]
        hh, last = scan(*ins)
        out = (hh * cot_h.to(dtype)).sum() + (last * cot_last.to(dtype)).sum()
        g = torch.autograd.grad(out, ins, allow_unused=True, materialize_grads=True)
        return dict(zip(("a", "bx", "h0"), g))

    t0 = time.perf_counter()
    got = grads(recurrent._rglru_scan, torch.float32)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    want = grads(sequential, torch.float64)
    ratios = {k: norm_ratio(got[k], want[k]) for k in want}
    with Swap("_rglru_scan", _scan_h0_dropped):
        faulty = grads(recurrent._rglru_scan, torch.float32)
    fault = {k: norm_ratio(faulty[k], want[k]) for k in want}
    log(f"phase r1: the RG-LRU scan's backward on layer 0's input {tuple(a.shape)} (h0 N(0, 1)) "
        f"against autograd through a sequential f64 recurrence: ||d|| / ||ref|| "
        + ", ".join(f"{k} {v:.3e}" for k, v in ratios.items()) + f" (limit {R_SCAN_GRAD_TOL}); "
        "with the h0 fold dropped (planted fault): "
        + ", ".join(f"{k} {v:.3e}" for k, v in fault.items())
        + f"; the scan's forward and backward {scan_s:.6f} s (one call)")
    check(max(ratios.values()) <= R_SCAN_GRAD_TOL, f"phase r1: the scan's gradients are "
          f"{ratios} of the f64 recurrence's norm from it (limit {R_SCAN_GRAD_TOL})")
    check(max(fault.values()) > R_SCAN_GRAD_TOL, f"phase r1: the planted fault lands under the "
          f"limit {R_SCAN_GRAD_TOL}: {fault}")
    return {"ratios": ratios, "fault": fault}


def wkv_grad_check(r, k, v, w, u, s0) -> dict:
    """(r2): the chunked WKV's backward on layer 0's real input (its first
    row and 1,024 tokens) against the scan form's, with seeded N(0, 1)
    cotangents on the output and the last state; then with the bonus
    dropped (a planted fault), which must land above ``R_WKV_GRAD_TOL``."""
    import torch

    from repro_torch.models import recurrent

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    cot_o = torch.randn(r.shape, generator=gen, device="cuda")
    cot_s = torch.randn(s0.shape, generator=gen, device="cuda")
    names = ("r", "k", "v", "w", "u")

    def grads(form):
        ins = [t.detach().clone().requires_grad_(True) for t in (r, k, v, w, u)]
        o, s = getattr(recurrent, form)(*ins, s0)
        g = torch.autograd.grad((o * cot_o).sum() + (s * cot_s).sum(), ins, allow_unused=True,
                                materialize_grads=True)
        return dict(zip(names, g))

    want = grads("_wkv_scan")
    ratios = {k_: norm_ratio(g, want[k_]) for k_, g in grads("_wkv_chunked").items()}
    with no_bonus():
        fault = {k_: norm_ratio(g, want[k_]) for k_, g in grads("_wkv_chunked").items()}
    log(f"phase r2: the chunked WKV's backward on layer 0's input {tuple(r.shape)} against the "
        "scan's: ||d|| / ||scan|| " + ", ".join(f"{k_} {v_:.3e}" for k_, v_ in ratios.items())
        + f" (limit {R_WKV_GRAD_TOL}); with the bonus dropped (planted fault): "
        + ", ".join(f"{k_} {v_:.3e}" for k_, v_ in fault.items()))
    check(max(ratios.values()) <= R_WKV_GRAD_TOL, f"phase r2: the WKV forms' backward differ by "
          f"{ratios} (limit {R_WKV_GRAD_TOL})")
    check(max(fault.values()) > R_WKV_GRAD_TOL, f"phase r2: the planted fault lands under the "
          f"limit {R_WKV_GRAD_TOL}: {fault}")
    return {"ratios": ratios, "fault": fault}


def train_recurrentgemma(counters: Counters) -> dict:
    """(r1): RecurrentGemma-9B at its published widths, cut to ``R_RG``'s
    layers: the training run of :func:`train_published` (the RG-LRU and
    attention leaves' gradients non-zero), then the first RG-LRU layer's
    backward against an f64 recurrence (:func:`rglru_grad_check`)."""
    import torch

    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.models import recurrent
    from repro_torch.models import transformer as tf

    n_layers, batch, seq = R_RG
    torch.cuda.reset_peak_memory_stats()
    cfg, params = recurrent_model(RG_ARCH, n_layers, "r1")
    pipe = SyntheticTokenPipeline(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=SEED,
                                  device="cuda")
    watched = {"w_rec_in", "w_gate_in", "w_out", "conv_w", "a_gate", "a_gate_bias", "i_gate",
               "i_gate_bias", "lambda", "wq", "wk", "wv", "wo"}
    out = train_published(counters, "r1", cfg, params, pipe.next_batch, batch, seq,
                          nonzero=lambda n: n.rsplit("/", 1)[-1] in watched)
    with torch.no_grad(), Capture(recurrent, "_rglru_scan") as scan:
        tf.forward_hidden(cfg, out["state"]["params"], pipe.next_batch()["tokens"])
    a, bx, _ = scan.args
    del scan, out["state"], out["tcfg"]
    out["scan"] = rglru_grad_check(a, bx)
    del a, bx
    torch.cuda.empty_cache()
    return out


def train_rwkv(counters: Counters) -> dict:
    """(r2): RWKV-6 3B at its published widths and depth: the training run
    of :func:`train_published` in the chunked WKV (every WKV leaf's gradient
    non-zero), the chunked WKV's backward on layer 0's input against the
    scan's (:func:`wkv_grad_check`); then the config's default scan form,
    one timed step of ``R_RWKV_SCAN``, whose gradients (handed to the
    optimizer) are held against the chunked form's on the same weights and
    batch, within ``R_FORMS_GRAD_TOL``, beside the chunked form with its
    bonus dropped."""
    import dataclasses

    import torch

    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.models import get_model, recurrent
    from repro_torch.models import transformer as tf
    from repro_torch.training import train_loop
    from repro_torch.tree import tree_leaves, tree_paths

    batch, seq = R_RWKV
    torch.cuda.reset_peak_memory_stats()
    cfg, params = recurrent_model(RWKV_ARCH, 0, "r2")
    scan_cfg = cfg                                  # the config's default form
    cfg = dataclasses.replace(cfg, rwkv_impl="chunked")
    pipe = SyntheticTokenPipeline(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=SEED,
                                  device="cuda")
    watched = {"mu_x", "mu_rkvwg", "shift_w1", "shift_w2", "w_r", "w_k", "w_v", "w_g", "w_o",
               "w0", "decay_w1", "decay_w2", "u", "ln_x_scale", "ln_x_bias"}
    out = train_published(counters, "r2", cfg, params, pipe.next_batch, batch, seq,
                          nonzero=lambda n: n.rsplit("/", 1)[-1] in watched)
    with torch.no_grad(), Capture(recurrent, "_wkv_chunked") as wkv:
        tf.forward_hidden(cfg, out["state"]["params"], pipe.next_batch()["tokens"])
    r, k, v, w, u, s0 = wkv.args
    del wkv
    out["wkv"] = wkv_grad_check(*(t[:1, :1024] for t in (r, k, v, w)), u, s0[:1])
    del r, k, v, w, u, s0

    b1, s1 = R_RWKV_SCAN
    small = SyntheticTokenPipeline(vocab=cfg.vocab, seq_len=s1, global_batch=b1,
                                   seed=SEED + 1, device="cuda").next_batch()
    state = out.pop("state")
    params = state["params"]
    names = [k for k, _ in tree_paths(params)]
    leaves = tree_leaves(params)

    def grads_of(c):
        loss_fn = train_loop.make_loss_fn(get_model(c), train_loop.TrainConfig())
        return torch.autograd.grad(loss_fn(params, small), leaves, allow_unused=True,
                                   materialize_grads=True)   # u, where the fault drops it

    chunked = grads_of(cfg)                          # at the weights the scan step starts from
    with no_bonus():
        faulty = grads_of(cfg)
    scan_step = train_loop.make_train_step(get_model(scan_cfg), out.pop("tcfg"))
    counters.zero()
    with Capture(train_loop, "adamw_update") as update:
        start = cuda_event()
        state, m = scan_step(state, small)
        end = cuda_event()
        end.synchronize()
    counters.read("phase r2 (the scan form's step)", ())
    scan_s = start.elapsed_time(end) / 1e3
    scan = tree_leaves(update.args[2])
    del update
    ratios = {n: leaf_ratio(c, s_) for n, c, s_ in zip(names, chunked, scan)}
    fault = {n: leaf_ratio(f, s_) for n, f, s_ in zip(names, faulty, scan)}
    del chunked, faulty, scan
    worst = max(ratios, key=ratios.get)
    worst_fault = max(fault, key=fault.get)
    fwd = forward_flops(scan_cfg, b1, s1)
    out["forms"] = {"max": ratios[worst], "fault_max": fault[worst_fault], "scan_step_s": scan_s}
    log(f"phase r2: the config's default scan form, one step of {b1} x {s1}: loss "
        f"{m['loss'].item():.6f}, step wall {scan_s:.6f} s (CUDA events, one step, the form's "
        f"first; bound {3 * fwd / TENSOR_FLOPS_PER_S:.6f} s); its gradients against the chunked "
        f"form's on the same weights and batch, ||chunked - scan|| / ||scan|| a leaf: max "
        f"{ratios[worst]:.6e} ({worst}), median {float(np.median(list(ratios.values()))):.6e} "
        f"(limit {R_FORMS_GRAD_TOL}); the chunked form with its bonus dropped (planted fault): "
        f"max {fault[worst_fault]:.6e} ({worst_fault}), median "
        f"{float(np.median(list(fault.values()))):.6e}")
    check(np.isfinite(m["loss"].item()), "phase r2: the scan form's loss is not finite")
    check(ratios[worst] <= R_FORMS_GRAD_TOL, f"phase r2: the WKV forms' gradients differ by "
          f"{ratios[worst]} at {worst} (limit {R_FORMS_GRAD_TOL})")
    check(fault[worst_fault] > R_FORMS_GRAD_TOL, f"phase r2: the planted fault lands under the "
          f"limit {R_FORMS_GRAD_TOL}: {fault[worst_fault]}")
    del state, params, leaves
    torch.cuda.empty_cache()
    return out


def train_encdec(counters: Counters) -> dict:
    """(r3): SeamlessM4T-medium at its published widths and depth: the
    training run of :func:`train_published` on batches of N(0, 1) bf16
    frames (as phase (p) draws them) and synthetic tokens, every encoder and
    cross-attention leaf's gradient non-zero, flash never launched."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.models import count_params, get_model

    batch, enc_seq, seq = R_ED
    cfg = ARCHS[ED_ARCH]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = get_model(cfg).init(torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in _leaves(params))
    n_norms = sum(t.numel() for name, t in _leaves(params) if "norm" in name)
    pad = (cfg.padded_vocab - cfg.vocab) * cfg.d_model * 2   # embed and lm_head
    log(f"phase r3: {cfg.name} at its published widths and depth ({cfg.enc_layers} encoder and "
        f"{cfg.n_layers} decoder layers, d {cfg.d_model}, vocab {cfg.vocab}): {n_params} "
        f"parameters, drawn on the card in {time.perf_counter() - t0:.3f} s")
    check(n_params - n_norms == count_params(cfg) + pad,
          f"phase r3: {n_params - n_norms} parameters against count_params {count_params(cfg)} "
          f"+ {pad} padding")
    pipe = SyntheticTokenPipeline(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=SEED,
                                  device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)

    def next_batch():   # the stub frontend's frames, N(0, 1) bf16
        return {"frames": torch.randn((batch, enc_seq, cfg.d_model), generator=gen,
                                      device="cuda").to(torch.bfloat16), **pipe.next_batch()}

    out = train_published(counters, "r3", cfg, params, next_batch, batch, seq, enc_seq=enc_seq,
                          nonzero=lambda n: n.startswith(("enc/", "dec/cross/")))
    del out["state"], out["tcfg"]
    torch.cuda.empty_cache()
    return out


def drive_recurrent_training(root: Path, counters: Counters) -> dict:
    """Phase (r): (r1) RecurrentGemma-9B and (r2) RWKV-6 3B trained at their
    published widths (RecurrentGemma's depth cut), (r3) SeamlessM4T-medium
    at its widths and depth, each alone on the card; (r4) the reduced driver
    on both recurrent archs with saves, a preemption and a resume."""
    out = {"r1": train_recurrentgemma(counters)}
    out["r2"] = train_rwkv(counters)
    out["r3"] = train_encdec(counters)
    out["r4"] = {arch: drive_reduced_driver(root, counters, "r4", dict(Q_DRIVER_RUN, arch=arch))
                 for arch in R_DRIVER_ARCHS}
    return out


# ------------------------------------- (s) the dots remat policy, the CLIs
S_SAVED = ("wq", "wk", "wv", "wo", "w_gate", "w_up")  # the products dots saves a layer
# the overhead gate's budget here: on the card's host the share read 1.909% of
# a 17.57 us warm checkout against the CLI's default 2% (3 points x 112 ns), so
# a host a tenth slower at a Python call would fail a run that found nothing
# wrong; the share is printed either way
S_OVERHEAD_BUDGET_PCT = 5.0


@contextlib.contextmanager
def remat_policy(policy: str):
    """``REPRO_REMAT_POLICY`` set to ``policy`` for the block, then restored."""
    old = os.environ.get("REPRO_REMAT_POLICY")
    os.environ["REPRO_REMAT_POLICY"] = policy
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("REPRO_REMAT_POLICY")
        else:
            os.environ["REPRO_REMAT_POLICY"] = old


def backward_peak(loss_fn, params, batch, leaves) -> tuple:
    """One loss and backward: the gradients and the peak device memory
    above what was allocated before (GiB)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = torch.autograd.grad(loss_fn(params, batch), leaves)
    torch.cuda.synchronize()
    return grads, (torch.cuda.max_memory_allocated() - base) / 2**30


def train_dots(root: Path, counters: Counters) -> dict:
    """Phase (s1): phase (k)'s run (minicpm-2b at full width and depth, 5
    steps of 8 x 1024 through ``launch.train.train``) under
    ``REPRO_REMAT_POLICY=dots``, a traced step, and one backward on the same
    state and batch under ``full`` and under ``dots``, whose gradients must
    be the same bits."""
    import torch

    from repro_torch.launch.train import RunConfig, run_model_config, train, train_config
    from repro_torch.training.train_loop import make_loss_fn, make_train_step
    from repro_torch.tree import tree_leaves, tree_paths

    run = RunConfig(**TRAIN_RUN, seed=SEED, ckpt_dir=str(root / "ckpt"))
    cfg = run_model_config(run)
    with remat_policy("dots"):
        torch.cuda.reset_peak_memory_stats()
        counters.zero()
        out = train(run, device="cuda", log_every=10**9)
        counts = counters.read("phase s1 (training under dots)", ())
        check(counts["flash_attention"] == 0,
              f"phase s1: training launched flash_attention {counts['flash_attention']} times")
        out["manager"].close()
        peak = torch.cuda.max_memory_allocated() / 2**30
        for i, (loss, gn, s) in enumerate(zip(out["losses"], out["grad_norms"], out["step_s"])):
            check(np.isfinite(loss) and np.isfinite(gn), f"phase s1: step {i}: loss {loss}, "
                  f"grad norm {gn}")
            log(f"phase s1: step {i}: loss {loss:.6f}, grad norm {gn:.6f}, step wall {s:.6f} s"
                + (" (the first: allocations, cuBLAS plans)" if i == 0 else ""))
        steady = out["step_s"][1:]
        mean = sum(steady) / len(steady)
        tokens = run.global_batch * run.seq_len
        fwd = forward_flops(cfg, run.global_batch, run.seq_len)
        bound_s = 3 * fwd / TENSOR_FLOPS_PER_S
        D, F = cfg.d_model, cfg.d_ff
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        saved_w = D * H * hd + 2 * D * KV * hd + H * hd * D + 2 * D * F
        skipped = 2 * tokens * cfg.n_layers * saved_w
        saved_bytes = tokens * cfg.n_layers * (H * hd + 2 * KV * hd + D + 2 * F) * 2
        log(f"phase s1: {cfg.name} under dots: batch {run.global_batch} x {run.seq_len}; steps "
            f"1-{len(out['step_s']) - 1}: mean {mean:.6f} s, min {min(steady):.6f}, max "
            f"{max(steady):.6f} ({tokens / mean:.1f} tokens/s); bound {bound_s:.6f} s (3 forward "
            f"passes, {3 * fwd / 1e12:.3f} TFLOP; bound / step {bound_s / mean:.4f}); the "
            f"recompute dots leaves out: {skipped / 1e12:.3f} TFLOP of weight products "
            f"({', '.join(S_SAVED)}), {skipped / TENSOR_FLOPS_PER_S:.6f} s at the peak rate; "
            f"their saved outputs {saved_bytes / 1e9:.3f} GB ({saved_bytes / 2**30:.3f} GiB); "
            f"peak device memory {peak:.3f} GiB")
        bundle, tcfg = out["bundle"], train_config(run)
        state = traced_step(counters, "s1", make_train_step(bundle, tcfg), out["final_state"],
                            out["pipe"].next_batch())
    params, batch = state["params"], out["pipe"].next_batch()
    del state, out
    torch.cuda.empty_cache()

    names = [k for k, _ in tree_paths(params)]
    leaves = tree_leaves(params)
    loss_fn = make_loss_fn(bundle, tcfg)
    with remat_policy("full"):
        full, full_peak = backward_peak(loss_fn, params, batch, leaves)
    with remat_policy("dots"):
        dots, dots_peak = backward_peak(loss_fn, params, batch, leaves)
    counters.read("phase s1 (checks)", ())
    differ = {n: float((a.float() - b.float()).abs().max())
              for n, a, b in zip(names, full, dots) if not torch.equal(a, b)}
    check(not differ, f"phase s1: {len(differ)} of {len(names)} leaves' gradients differ "
          f"between full and dots: {dict(list(differ.items())[:6])}")
    log(f"phase s1: one backward on the same state and batch: all {len(names)} leaves' "
        f"gradients bit-equal under full and dots; the backward's peak above the state "
        f"{full_peak:.3f} GiB (full), {dots_peak:.3f} GiB (dots)")
    del full, dots, params, leaves
    torch.cuda.empty_cache()
    return {"step_s": mean, "tokens_s": tokens / mean, "bound_s": bound_s, "peak_gib": peak,
            "backward_peak_gib": (full_peak, dots_peak)}


# a wrapper planted to write into its argument through a launch: the XOR
# kernel handed its first argument as its output, which no dispatch mode sees
PLANTED_AUDIT = """
import sys
import torch
from repro_torch import kernels
from repro_torch.analysis import cli, kernel_audit as KA

def xor_into_argument(a, b):
    kernels.launch("block_xor_delta", a.device, a.data_ptr(), b.data_ptr(), a.data_ptr(),
                   a.shape[0])
    return torch.empty_like(a)

def build(dev):
    g = torch.Generator().manual_seed(0)
    a, b = (torch.randint(0, 2**31 - 1, (64, 8, 128), generator=g, dtype=torch.int32).to(dev)
            for _ in range(2))
    return xor_into_argument, (a, b)

KA.audit_targets = lambda: [KA.AuditTarget("planted.xor_into_argument", build)]
sys.exit(cli.main(sys.argv[1:]))
"""


def cli_start(args: list) -> tuple:
    """Start ``python args`` from the checkout's root as a subprocess; returns
    (process, start time) for :func:`cli_wait`."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return (subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE),
            time.perf_counter())


def cli_wait(label: str, started: tuple, want_rc: int) -> tuple:
    """Wait for a :func:`cli_start` subprocess (killed after 600 s); its exit
    status must be ``want_rc``.  Returns (stdout, wall)."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=max(1.0, 600 - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    wall = time.perf_counter() - t0
    check(proc.returncode == want_rc, f"phase s2: {label} exited {proc.returncode}, not "
          f"{want_rc}:\n{out[-2000:]}\n{err[-4000:]}")
    log(f"phase s2: {label}: exit {proc.returncode} in {wall:.3f} s")
    return out, wall


def drive_clis(root: Path, counters: Counters, smi: str) -> dict:
    """Phase (s2): the two CLIs on the card, each a subprocess whose exit
    status is checked: the kernel audit against the committed baseline (every
    target ran, nothing new: 0) and over a planted wrapper alone that writes
    its argument through a launch (1, ``audit.arg-write`` from the bytes); fsck of
    the synthetic store (0) and of a store with one object deleted (1,
    ``fsck.missing-object``); the obs summary; these five at once (each
    wall is its own, shared with the others), then the tracer's overhead
    gate alone, since it times a warm checkout."""
    from repro_torch.analysis.cli import DEFAULT_BASELINE, build_synthetic_store
    from repro_torch.analysis.kernel_audit import audit_targets

    store = root / "fsck_store"
    counters.zero()
    build_synthetic_store(store).close()
    counters.read("phase s2 (the fsck store's commits and repack)", ("changed_block_mask",))
    objects = sorted((store / "objects").rglob("*.zst"))
    objects[len(objects) // 2].unlink()
    baseline = ["--baseline", str(ROOT / DEFAULT_BASELINE)]
    started = {
        "audit": cli_start(["-m", "repro_torch.analysis", "audit", "--json", *baseline]),
        "planted": cli_start(["-c", PLANTED_AUDIT, "audit", "--json", *baseline]),
        "fsck": cli_start(["-m", "repro_torch.analysis", "fsck", "--synthetic"]),
        "fsck deleted": cli_start(["-m", "repro_torch.analysis", "fsck", str(store), "--json"]),
        "summary": cli_start(["-m", "repro_torch.obs", "summary", "--synthetic", "--json"]),
    }
    try:
        out, _ = cli_wait("audit", started["audit"], 0)
        report = json.loads(out)
        ran = report["checked"]["audit.trace"]
        traced = [f for f in report["findings"] if f["rule"] == "audit.trace"]
        check(ran == len(audit_targets()) and not traced and report["new"] == 0,
              f"phase s2: audit ran {ran} of {len(audit_targets())} targets, {traced}, "
              f"{report['new']} new")
        by_rule: dict = {}
        for f in report["findings"]:
            key = f"{f['rule']}:{f['severity']}"
            by_rule[key] = by_rule.get(key, 0) + 1
        log(f"phase s2: audit on the card: {ran} targets ran, "
            f"{sum(report['checked'].values())} checks; findings by rule "
            f"{json.dumps(by_rule, sort_keys=True)}; 0 new")

        out, _ = cli_wait("audit with a planted wrapper", started["planted"], 1)
        planted = [f for f in json.loads(out)["findings"]
                   if f["subject"] == "planted.xor_into_argument"
                   and f["rule"] == "audit.arg-write"]
        check(len(planted) == 1 and planted[0]["severity"] == "error"
              and "argument 0's bytes changed" in planted[0]["message"],
              f"phase s2: the planted write was not caught by its bytes: {planted}")
        log(f"phase s2: the planted write caught: {planted[0]['message']}")

        cli_wait("fsck --synthetic", started["fsck"], 0)
        out, _ = cli_wait("fsck of a store with an object deleted", started["fsck deleted"], 1)
        rules = {f["rule"] for f in json.loads(out)["findings"]}
        check("fsck.missing-object" in rules, f"phase s2: fsck found {rules}")

        out, _ = cli_wait("obs summary", started["summary"], 0)
        spans = json.loads(out)["spans"]
        check({"store.commit", "delta.apply_chains", "core.optimize"} <= set(spans),
              f"phase s2: spans {sorted(spans)}")
        log("phase s2: obs summary spans: " + ", ".join(
            f"{k} x{v['count']}" for k, v in sorted(spans.items())))
    finally:
        for proc, _ in started.values():  # stops any left after a failed check
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    out, _ = cli_wait("obs overhead", cli_start(
        ["-m", "repro_torch.obs", "overhead", "--budget-pct", str(S_OVERHEAD_BUDGET_PCT)]), 0)
    overhead = json.loads(out[: out.rindex("}") + 1])
    log(f"phase s2: disabled-tracer overhead {overhead['overhead_pct']}% of a "
        f"{overhead['warm_checkout_us']} us warm checkout ({overhead['instrumentation_points']} "
        f"points x {overhead['disabled_span_ns']} ns; gated at {overhead['budget_pct']}%, the "
        f"CLI's default 2.0%) on {smi}")
    return {"overhead_pct": overhead["overhead_pct"]}


# ------------------------------------------------------- (t) the example twins
TWINS = ("quickstart", "dataset_versions", "serve_batched", "serve_dataset",
         "branching_finetune")
# the kernels each twin's path must launch on the card; "a|b" takes either
TWIN_NEEDS = {
    "quickstart": ("changed_block_mask", "chain_delta_apply|sparse_delta_apply",
                   "segment_min_rows", "segment_argmin_rows", "min_argmin_1d", "mp_loop"),
    "dataset_versions": ("changed_block_mask", "chain_delta_apply|sparse_delta_apply"),
    "serve_batched": ("changed_block_mask", "chain_delta_apply|sparse_delta_apply"),
    "serve_dataset": ("changed_block_mask", "segment_min_rows", "segment_argmin_rows"),
    # every save changes every block, so nothing is stored as a delta and no
    # delta is applied; the P3 repack starts from the SPT
    "branching_finetune": ("changed_block_mask", "segment_min_rows", "segment_argmin_rows"),
}
# phase (b)'s leaves that the isolation check commits: an edited and a shared one
ISOLATION_LEAVES = ("tokens/i8", "mask/valid")


def load_twin(stem: str):
    """``examples/<stem>_torch.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"{stem}_torch",
                                                  ROOT / "examples" / f"{stem}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quietly(fn, *args):
    """``fn(*args)`` with its standard output kept out of the log."""
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def scribble(tree: dict) -> None:
    """Write into the first 4 KiB of every leaf."""
    import torch

    for t in tree.values():
        raw = t.view(-1).view(torch.uint8)[:BLOCK]
        raw.copy_(raw ^ 1)


def isolation_check(root: Path, counters: Counters) -> None:
    """Phase (t)'s isolation contract on the card: a write into a warm
    checkout, into one result of a batch and into one of two coalesced
    service results reaches no other tree; each later tree is held against
    the ground truth by sha256."""
    import asyncio

    from repro_torch.store import Repository

    rng = np.random.default_rng(SEED)
    v0 = make_dataset(rng, {n: LEAVES[n] for n in ISOLATION_LEAVES})
    v1 = dict(v0, **{ISOLATION_LEAVES[0]: edit_blocks(rng, v0[ISOLATION_LEAVES[0]])})
    truth = [{n: leaf_digest(a) for n, a in tree.items()} for tree in (v0, v1)]
    counters.zero()
    repo = Repository(root, device="cuda")
    vids = [repo.commit(as_payload(tree)) for tree in (v0, v1)]

    def holds(tree: dict, i: int, what: str) -> None:
        got = {n: leaf_digest(t) for n, t in tree.items()}
        check(got == truth[i], f"phase t: {what} is not v{i}'s committed content")

    repo.checkout(vids[1])
    t0 = time.perf_counter()
    warm = repo.checkout(vids[1])
    warm_s = time.perf_counter() - t0
    holds(warm, 1, "a warm checkout")
    scribble(warm)
    holds(repo.checkout(vids[1]), 1, "the checkout after a write into a warm one")
    a, b = repo.checkout_many(vids)
    scribble(a)
    holds(b, 1, "a batch's other result after a write into its first")
    holds(repo.checkout(vids[0]), 0, "the checkout after a write into a batch result")

    async def coalesced():
        async with repo.serve(readers=2, batch_window_s=0.005) as svc:
            first, second = await asyncio.gather(svc.checkout(vids[1]),
                                                 svc.checkout(vids[1]))
            scribble(first)
            return second, await svc.checkout(vids[1]), svc.metrics.counter("checkout.coalesced")

    second, later, coalesced_n = asyncio.run(coalesced())
    check(coalesced_n == 1, f"phase t: {coalesced_n} of 2 service requests coalesced, not 1")
    holds(second, 1, "a coalesced client's tree after the other client wrote into its own")
    holds(later, 1, "the service's next checkout after a client's write")
    repo.close()
    counters.read("phase t (isolation)", ("changed_block_mask",
                                          "chain_delta_apply|sparse_delta_apply"))
    mib = sum(a.nbytes for a in v1.values()) / 2**20
    log(f"phase t: isolation held on the card ({mib:.1f} MiB a version: a warm checkout, a "
        f"batch result and a coalesced service result written into; every later tree equal "
        f"to its sha256); the warm checkout with its copy {warm_s:.6f} s")


def drive_twins(root: Path, counters: Counters) -> dict:
    """Phase (t): each example twin's ``main(["--device", "cuda"])`` in this
    process, its kernels counted, its printed invariants held against the
    same twin on the CPU or against the JAX original's numbers; then the
    isolation contract."""
    root.mkdir(parents=True, exist_ok=True)
    walls = {}
    for stem in TWINS:
        twin = load_twin(stem)
        args = ["--device", "cuda"]
        if stem == "serve_dataset":
            args += ["--trace-out", str(root / "serve_dataset_trace.json")]
        log(f"phase t: --- examples/{stem}_torch.py on the card ---")
        counters.zero()
        t0 = time.perf_counter()
        facts = twin.main(args)
        walls[stem] = time.perf_counter() - t0
        counts = counters.read(f"phase t ({stem})", TWIN_NEEDS[stem])
        launched = {k: v for k, v in counts.items() if v}
        if stem == "quickstart":
            cpu = {"figure1": quietly(twin.figure1, "cpu"),
                   "frontier": quietly(twin.frontier, "cpu")}
            for key, want in cpu.items():
                check(facts[key] == want, f"phase t: quickstart's {key} on the card "
                      f"{facts[key]} != the CPU's {want}")
        elif stem == "dataset_versions":
            want = quietly(twin.main, ["--device", "cpu"])
            check(facts == want, f"phase t: dataset_versions on the card {facts} != the CPU's "
                  f"{want}")
        elif stem == "serve_batched":
            check(facts["coalesced"] == 7 and facts["batch_dispatches"] == 1,
                  f"phase t: serve_batched {facts}: not 7 of 8 coalesced and 1 dispatch")
        elif stem == "serve_dataset":
            check(facts["invalidations"] == 0 and facts["purges"] >= 1,
                  f"phase t: serve_dataset {facts}: not 0 invalidations and a purge")
        else:
            check(facts["hits_of_26"] == 25,
                  f"phase t: branching_finetune served {facts['hits_of_26']} of 26 from the "
                  f"cache, not 25")
        log(f"phase t: {stem}: wall {walls[stem]:.3f} s on the card; launches "
            f"{json.dumps(launched)}; invariants held")
    isolation_check(root / "isolation", counters)
    return walls


def card_name_and_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def drive_dots_and_clis(root: Path, counters: Counters) -> dict:
    """Phase (s): (s1) training under the dots remat policy, (s2) the CLIs."""
    return {"s1": train_dots(root, counters),
            "s2": drive_clis(root, counters, card_name_and_limit())}


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the port on one NVIDIA GPU.")
    ap.add_argument("--only", default=PHASES, metavar="LETTERS",
                    help="run only these phases (a development aid: a partial run "
                         "prints no result line); default: all of " + PHASES)
    only = ap.parse_args(argv).only
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels

    start = time.perf_counter()
    # a run still going near the 1,200 s limit leaves every thread's stack
    # on standard error, beside the phase it reached (below)
    faulthandler.dump_traceback_later(STACKS_AFTER_S, exit=False)
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = kernels.build()  # one nvcc per source, all at once
    log(f"build: {', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.3f} s")
    for lib in libs.values():
        for line in lib.with_suffix(".log").read_text().splitlines():
            # registers, spills, errors, and ptxas serialising wgmma (C7514)
            if any(w in line for w in ("registers", "spill", "error", "Performance Loss")):
                log(f"  ptxas {lib.stem}: {line.strip()}")
    for stem in libs:
        kernels.library(stem)

    def phase(letter, fn, *args):
        if letter not in only:
            return None
        t0 = time.perf_counter()
        print(f"chip_smoke: phase {letter} starts at {t0 - start:.1f} s", file=sys.stderr,
              flush=True)
        out = fn(*args)
        log(f"phase {letter}: wall {time.perf_counter() - t0:.3f} s")
        return out

    results = []
    results += phase("a", kernel_checks, dev) or []
    results += phase("e", segment_checks, dev) or []
    results += phase("h", flash_checks, dev) or []

    counters = Counters()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="chip_smoke_") as tmp:
        if "b" in only:  # (c) and (d) read (b)'s store and ground truth
            truth = phase("b", drive_commits, Path(tmp) / "repo", counters)
            phase("c", drive_checkouts, Path(tmp) / "repo", truth, counters)
            phase("d", breakdown, Path(tmp) / "repo", truth)
            phase("j", drive_block_ops, truth, counters)
            del truth
        phase("f", lambda: (drive_solvers(counters), solver_trace()))
        phase("g", drive_repack, Path(tmp) / "repack", counters)
        phase("i", drive_service, Path(tmp) / "service", counters)
        phase("l", drive_checkpoint_loop, Path(tmp) / "train_loop", counters)
        phase("t", drive_twins, Path(tmp) / "twins", counters)
    phase("h", drive_serving, counters)
    with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="chip_smoke_") as tmp:
        phase("u", drive_mesh, Path(tmp), counters)
    phase("m", drive_deepseek, counters)
    phase("n", drive_phi, counters)
    phase("o", drive_recurrent, counters)
    phase("p", drive_encdec, counters)
    with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="chip_smoke_") as tmp:
        phase("k", drive_training, Path(tmp), counters)
    with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="chip_smoke_") as tmp:
        phase("q", drive_moe_training, Path(tmp), counters)
    with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="chip_smoke_") as tmp:
        phase("r", drive_recurrent_training, Path(tmp), counters)
    with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="chip_smoke_") as tmp:
        phase("s", drive_dots_and_clis, Path(tmp), counters)
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"total wall {time.perf_counter() - start:.3f} s")
    faulthandler.cancel_dump_traceback_later()
    import torch.distributed as dist

    if dist.is_initialized():  # phase (u)'s NCCL group
        dist.destroy_process_group()

    for r in results:
        r["launches"] = counters.total[r["name"]]
    print(card_name_and_limit())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "launch_floor_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r} for r in results]}))
    if only != PHASES:
        print(f"chip_smoke: partial run of phases {only}; no result")
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
