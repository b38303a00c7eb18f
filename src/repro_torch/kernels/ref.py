"""Plain PyTorch versions of the port's kernels.

The delta-path functions operate on the canonical *block layout*: a tensor's
backing bytes are viewed as ``(num_blocks, 8, 128)`` int32, one 4 KiB
storage block per row: the XOR delta, the changed-block mask, the block
hash, the sparse scatter and the fused chain. The shape is kept from the JAX
package (where a block is one TPU VMEM tile) so that wire bytes match; on
the GPU a block is simply 1024 words. The solver functions reduce padded f32
rows and run the Prim and Modified-Prim step loops. ``flash_attention_ref``
is the plain version of the attention kernel.

These functions are what the kernel wrappers run for CPU tensors, and what
``chip_smoke.py`` holds each CUDA kernel against on the card.  None of them
writes into its arguments, except the step loops (``prim_loop_ref``,
``mp_loop_ref``, and ``mp_reparent_ref``, one re-parenting pass of the MP
loop), which update the solver's own loop buffers in place, as their
kernels do.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

BLOCK_SHAPE = (8, 128)
BLOCK_ELEMS = BLOCK_SHAPE[0] * BLOCK_SHAPE[1]
BLOCK_BYTES = BLOCK_ELEMS * 4


def xor_delta_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bitwise delta between two same-shape int32 block arrays (the paper's
    XOR delta).  Self-inverse: ``xor_delta_ref(a, xor_delta_ref(a, b)) == b``.
    """
    return torch.bitwise_xor(a, b)


def changed_block_mask_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(num_blocks, 1) int32 mask: 1 where a block differs anywhere."""
    return (a != b).flatten(1).any(dim=1).to(torch.int32)[:, None]


def block_hash_ref(x: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """(num_blocks, 1) int32 position-weighted multiplicative hash.

    ``coef`` is an (8, 128) int32 array of odd per-position multipliers; the
    hash is Σ x[s,l]·coef[s,l] with int32 wraparound, i.e. the sum mod 2**32
    read as a two's-complement int32.  The wrap is made explicit: products
    are taken in int64 (exact for int32 operands) and cut to their low 32
    bits, the block's 1024 of them summed in int64 (< 2**42, exact), and the
    sum cut to 32 bits again.  (A narrowing ``.to(torch.int32)`` of an
    out-of-range int64 is not a documented wrap.)
    """
    low = 0xFFFFFFFF
    prod = (x.to(torch.int64) * coef.to(torch.int64)) & low
    s = prod.flatten(1).sum(dim=1) & low
    return (s - ((s >> 31) << 32)).to(torch.int32)[:, None]


def sparse_delta_apply_ref(
    base: torch.Tensor, blocks: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """Scatter packed delta blocks into a copy of ``base``.

    base   : (num_blocks, 8, 128) int32
    blocks : (k, 8, 128) int32 packed changed blocks
    idx    : (k,) int32 destination block rows; ``idx < 0`` and
             ``idx >= num_blocks`` are dropped (padding)

    Where two slots name one row the later slot wins, as the JAX reference's
    in-order scatter does; the result does not depend on the backend's
    handling of duplicate indices.
    """
    nb = base.shape[0]
    out = base.clone()
    valid = (idx >= 0) & (idx < nb)
    rows = idx[valid].long()
    if rows.numel() == 0:
        return out
    src = blocks[valid]
    slot = torch.arange(rows.numel(), device=rows.device)
    winner = torch.full((nb,), -1, dtype=torch.long, device=rows.device)
    winner.scatter_reduce_(0, rows, slot, reduce="amax")
    keep = winner[rows] == slot
    out[rows[keep]] = src[keep]
    return out


def chain_delta_apply_ref(
    base: torch.Tensor, blocks: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """Apply a whole chain of packed deltas in chain order.

    base   : (num_blocks, 8, 128) int32
    blocks : (K, capacity, 8, 128) int32 (or flat (S, 8, 128))
    idx    : (K, capacity) int32 (or flat (S,)); negative = padding

    The sparse deltas carry new block *content*, so composition is
    last-writer-wins per row, and the flat slot order is the chain order:
    one last-writer-wins scatter of the flattened stack equals applying the
    K steps one after another (the JAX reference's stepwise fold).
    """
    return sparse_delta_apply_ref(
        base, blocks.reshape((-1,) + BLOCK_SHAPE), idx.reshape(-1)
    )


# ------------------------------------------------------ solver segment ops
#: MP's re-parenting slack, compared in f32; ``kEps`` in
#: ``csrc/segment_kernels.cu`` is the same value, and equal to the solvers'
#: ``repro_torch.core.solvers.EPS`` (a test holds all three together)
EPS = 1e-15

# NaN is the minimum and propagates, ties go to the first index, indices are
# int32: the semantics of XLA's min / argmin, which the JAX package's
# segment kernels and solvers rely on.  XLA's min orders -0.0 below +0.0;
# its argmin, like ``min_argmin_1d_ref``'s, holds the two zeros equal.


def segment_min_rows_ref(x: torch.Tensor) -> torch.Tensor:
    """(rows,) minimum of each row of a (rows, width) f32 matrix, as XLA's
    min: -0.0 where the minimum is zero and the row holds a -0.0, whatever
    the order (``torch.amin`` returns whichever zero it meets)."""
    m = torch.amin(x, dim=1)
    neg_zero = ((x == 0) & torch.signbit(x)).any(dim=1)
    return torch.where((m == 0) & neg_zero, torch.full_like(m, -0.0), m)


def segment_argmin_rows_ref(x: torch.Tensor) -> torch.Tensor:
    """(rows,) int32 index of the first minimum of each row."""
    return torch.argmin(x, dim=1).to(torch.int32)


def min_argmin_1d_ref(x: torch.Tensor):
    """(min, first argmin) of a flat f32 vector as 0-d tensors (f32, int32)."""
    i = torch.argmin(x)
    return x[i], i.to(torch.int32)


def mp_reparent_ref(
    pd: torch.Tensor,
    pdelta: torch.Tensor,
    pphi: torch.Tensor,
    vi: torch.Tensor,
    active: torch.Tensor,
    in_tree: torch.Tensor,
    l: torch.Tensor,
    d: torch.Tensor,
    p: torch.Tensor,
) -> None:
    """One Modified-Prim in-tree re-parenting pass, in place on ``l``, ``d``
    and ``p``: for each slot k of the selected vertex ``vi``'s out-row (in
    order), an in-tree neighbour ``vj`` is re-parented under ``vi`` when that
    does not raise its recreation cost ``d`` by more than :data:`EPS`, lowers
    its storage cost ``l`` by at least :data:`EPS`, and ``vj`` is not on ``vi``'s
    parent chain.  Comparisons are f32, as on the device."""
    if not bool(active):
        return
    v = int(vi)
    eps32 = torch.tensor(EPS, dtype=torch.float32)
    row = pd[v].tolist()
    in_row = in_tree[pd[v].long()].tolist()
    for k, vj in enumerate(row):
        if not in_row[k]:
            continue
        dn = pphi[v, k] + d[v]
        cdel = pdelta[v, k]
        if not (bool(dn <= d[vj] + eps32) and bool(cdel <= l[vj] - eps32)):
            continue
        x = v
        while x > 0 and x != vj:
            px = int(p[x])
            x = 0 if px < 0 else px
        if x == vj:
            continue
        p[vj] = v
        d[vj] = dn
        l[vj] = cdel


def prim_loop_ref(
    pd: torch.Tensor,
    pw: torch.Tensor,
    best: torch.Tensor,
    bp: torch.Tensor,
    in_tree: torch.Tensor,
    steps: int,
) -> None:
    """Prim's step loop over the undirected instance's padded out-rows, in
    place on ``best`` / ``bp`` / ``in_tree`` (``nvp + 2`` entries; index
    ``nvp + 1`` is the trash slot that masked scatters write).  Each step
    selects the vertex of least key (``+inf`` for tree vertices) with
    :func:`min_argmin_1d_ref`, puts it in the tree and, when its key is
    finite, relaxes its out-row with one scatter."""
    nvp, width = pd.shape
    dev = pd.device
    pd64 = pd.long()  # gathers/scatters index with it
    inf = torch.tensor(math.inf, dtype=torch.float32, device=dev)
    trash = torch.tensor(nvp + 1, dtype=torch.long, device=dev)
    for _ in range(steps):
        key = torch.where(in_tree[:nvp], inf, best[:nvp])
        bmin, u = min_argmin_1d_ref(key)
        active = torch.isfinite(bmin)
        u1 = u.view(1)
        in_tree.index_fill_(0, u1.long(), True)
        vs = pd64.index_select(0, u1).view(width)
        ws = pw.index_select(0, u1).view(width)
        imp = active & ~in_tree.index_select(0, vs) & (ws < best.index_select(0, vs))
        idx = torch.where(imp, vs, trash)
        best.index_copy_(0, idx, ws)
        bp.index_copy_(0, idx, u.expand(width))


def mp_loop_ref(
    pd: torch.Tensor,
    pdelta: torch.Tensor,
    pphi: torch.Tensor,
    bound: torch.Tensor,
    l: torch.Tensor,
    d: torch.Tensor,
    p: torch.Tensor,
    in_tree: torch.Tensor,
    steps: int,
) -> None:
    """The Modified-Prim step loop (Algorithm 2), in place on ``l`` / ``d`` /
    ``p`` / ``in_tree`` (``nvp + 2`` entries, trash slot ``nvp + 1``).  Each
    step selects the vertex of least ``l`` outside the tree, re-parents its
    in-tree neighbours with :func:`mp_reparent_ref` and relaxes the others
    under ``bound`` (0-d f32, θ + CONSTRAINT_TOL) with one scatter."""
    nvp, width = pd.shape
    dev = pd.device
    pd64 = pd.long()  # the loop's gathers and scatters
    inf = torch.tensor(math.inf, dtype=torch.float32, device=dev)
    eps = torch.tensor(EPS, dtype=torch.float32, device=dev)
    trash = torch.tensor(nvp + 1, dtype=torch.long, device=dev)
    for _ in range(steps):
        key = torch.where(in_tree[:nvp], inf, l[:nvp])
        li, vi = min_argmin_1d_ref(key)
        active = torch.isfinite(li)
        vi1 = vi.view(1)
        in_tree.index_copy_(0, vi1.long(), in_tree.index_select(0, vi1) | active)
        vs = pd64.index_select(0, vi1).view(width)
        it = in_tree.index_select(0, vs)  # snapshot used by the frontier mask
        # in-tree re-parenting (Algorithm 2 lines 10-17): sequential, each
        # acceptance rewires the ancestor chain consulted by the next slot
        mp_reparent_ref(pd, pdelta, pphi, vi, active, in_tree, l, d, p)
        # frontier relaxation under θ — one masked row op (padding carries
        # +inf costs, so both conditions mask it out)
        dts = pdelta.index_select(0, vi1).view(width)
        nd = pphi.index_select(0, vi1).view(width) + d.index_select(0, vi1)
        imp = active & ~it & (nd <= bound) & (dts < l.index_select(0, vs) - eps)
        idx = torch.where(imp, vs, trash)
        d.index_copy_(0, idx, nd)
        l.index_copy_(0, idx, dts)
        p.index_copy_(0, idx, vi.expand(width))


# -------------------------------------------------------------- attention
#: the masked score; not -inf, so that exp(s - m) of a masked key is 0 and
#: never NaN (``kernels/flash_attention.py:40`` of the JAX package)
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    softmax_scale: Optional[float] = None,
    block_k: int = 512,
) -> torch.Tensor:
    """Forward GQA attention as the JAX package's ``_flash_kernel`` computes
    it, over ``block_k``-key blocks with an online softmax.

    q    : (B, Sq, H, hd); k, v : (B, Sk, KV, hd), H a multiple of KV
    Query head ``h`` reads KV head ``h // (H // KV)``.  ``q`` is scaled in
    f32 and rounded back to its dtype; scores and the running max, sum and
    output are f32; ``p`` is rounded to ``v``'s dtype before the PV product;
    the causal mask compares global positions (query ``i`` sees keys
    ``<= i``) with :data:`NEG_INF`.  Returns (B, Sq, H, hd) in q's dtype.
    """
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    g = H // KV
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    bk = min(block_k, Sk)
    dev = q.device
    # (B, KV, g, Sq, hd): one KV head's group of query heads
    qs = (q.float() * scale).to(q.dtype).float()
    qs = qs.reshape(B, Sq, KV, g, hd).permute(0, 2, 3, 1, 4)
    kt = k.float().permute(0, 2, 1, 3)[:, :, None]          # (B, KV, 1, Sk, hd)
    vt = v.float().permute(0, 2, 1, 3)[:, :, None]
    q_pos = torch.arange(Sq, device=dev)[:, None]
    m = torch.full((B, KV, g, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, g, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, g, Sq, hd), dtype=torch.float32, device=dev)
    for k0 in range(0, Sk, bk):
        s = qs @ kt[..., k0:k0 + bk, :].transpose(-1, -2)   # (B, KV, g, Sq, bk)
        if causal:
            k_pos = torch.arange(k0, min(k0 + bk, Sk), device=dev)[None, :]
            s = torch.where(k_pos <= q_pos, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p.to(v.dtype).float() @ vt[..., k0:k0 + bk, :]
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)
