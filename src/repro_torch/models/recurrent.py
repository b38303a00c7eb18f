"""Recurrent blocks: RG-LRU (Griffin / RecurrentGemma) and RWKV-6 (Finch),
as ``repro.models.recurrent`` has them.

Both are sub-quadratic: O(S) prefill through scans, an O(1) state a decode
step.

* RG-LRU block (arXiv:2402.19427): two linear branches from the input; the
  recurrent branch runs conv1d (width 4) → RG-LRU, the gate branch GeLU (the
  tanh form, ``jax.nn.gelu``'s default); their product projects back to
  d_model.  The recurrence
      h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t),
      a_t = exp(−c·softplus(Λ)·σ(W_a x_t))
  is linear in h, so prefill takes the JAX package's associative scan
  (``jax.lax.associative_scan``'s odd/even recursion, log-depth), combined
  in the order JAX combines.

* RWKV-6 (arXiv:2404.05892): data-dependent token shift (LoRA), a
  data-dependent per-channel decay w_t and a matrix state per head
      S_t = diag(w_t) S_{t-1} + kᵀ_t v_t,   out_t = r_t·(S_{t-1} + diag(u) kᵀ_t v_t),
  through the sequential scan (the config's default, and every decode step)
  or the chunked form (``rwkv_impl="chunked"``, prompts a multiple of
  ``WKV_CHUNK``).

Unlike the JAX package, which returns new states, ``rglru_block`` and
``rwkv_block`` write their state into the caller's (the engine's buffer) in
place and return it.  With no state (teacher forcing, training) they start
from zeros and write nothing: a write into a zero state that autograd has
saved (the WKV's s0 is an operand of its first product) would fail the
backward pass's version check, and a buffer holding the last state would
keep the graph alive for as long as it lives.

Training differentiates both blocks as they stand: the associative scan's
odd/even recursion, ``_fma``'s f64 multiply-add, the WKV's Python loop over
tokens (whose backward keeps a (B, H, hd, hd) f32 state a step) and its
chunked form.  Where the JAX package bounds a value with ``jnp.maximum`` or
``jnp.clip`` (the RG-LRU's √(1 − a²) floor, the chunked WKV's log-decay
range), the port takes ``torch.maximum`` / ``torch.minimum``, which like
JAX hand each side half of the gradient at a tie; ``torch.clamp`` would
pass all of it (a decay of exactly 1.0, log-decay 0, would get twice
JAX's gradient).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import Params, group_norm_heads, rms_norm


# ================================================================== RG-LRU ==
_C = 8.0  # Griffin's fixed recurrence sharpness


def _fma(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``x * y + z`` of f32 tensors rounded once to f32, as XLA computes it
    (it contracts the multiply-add into one FMA): the product of two f32
    values is exact in f64, so only the sum rounds before the cast back
    (twice only where that sum lands on an f32 rounding midpoint)."""
    return torch.addcmul(z.double(), x.double(), y.double()).float()


def _assoc_scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along axis 1 of the pairs (a_t, b_t) under
    ``(a1, b1) ∘ (a2, b2) = (a1·a2, b1·a2 + b2)``, by
    ``jax.lax.associative_scan``'s recursion: combine adjacent pairs, scan
    those, then fill in the even positions, so every element is combined in
    JAX's order."""
    n = a.shape[1]
    if n < 2:
        return a, b
    a_lo, a_hi = a[:, 0:-1:2], a[:, 1::2]
    odd_a, odd_b = _assoc_scan(a_lo * a_hi, _fma(b[:, 0:-1:2], a_hi, b[:, 1::2]))
    if n % 2 == 0:
        odd_a_e, odd_b_e = odd_a[:, :-1], odd_b[:, :-1]
    else:
        odd_a_e, odd_b_e = odd_a, odd_b
    a_e, b_e = a[:, 2::2], b[:, 2::2]
    even_a = torch.cat([a[:, :1], odd_a_e * a_e], dim=1)
    even_b = torch.cat([b[:, :1], _fma(odd_b_e, a_e, b_e)], dim=1)
    out_a = torch.empty_like(a)
    out_b = torch.empty_like(b)
    out_a[:, 0::2], out_a[:, 1::2] = even_a, odd_a
    out_b[:, 0::2], out_b[:, 1::2] = even_b, odd_b
    return out_a, out_b


def _rglru_scan(a: torch.Tensor, bx: torch.Tensor,
                h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t*h_{t-1} + bx_t by the associative scan; returns (all h,
    last h).  a, bx: (B, S, W) f32; h0: (B, W) f32."""
    # fold h0 into the first step
    bx = torch.cat([_fma(a[:, :1], h0[:, None], bx[:, :1]), bx[:, 1:]], dim=1)
    _, hh = _assoc_scan(a, bx)
    return hh, hh[:, -1]


def rglru_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
                h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Core RG-LRU over a (B, S, W) branch input; returns (y, h_last)."""
    xf = x.float()
    r = torch.sigmoid(xf * p["a_gate"].float() + p["a_gate_bias"].float())
    i = torch.sigmoid(xf * p["i_gate"].float() + p["i_gate_bias"].float())
    log_a = -_C * F.softplus(p["lambda"].float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.maximum(1.0 - a * a, a.new_tensor(1e-12))) * (i * xf)
    h, h_last = _rglru_scan(a, gated, h0.float())
    return h.to(x.dtype), h_last


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 buf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d, width K.  x: (B, S, W); w: (K, W); buf:
    (B, K-1, W) past inputs.  Returns (y, new_buf)."""
    K = w.shape[0]
    ext = torch.cat([buf.to(x.dtype), x], dim=1)
    y = sum(ext[:, i: ext.shape[1] - (K - 1 - i)] * w[i][None, None, :] for i in range(K))
    new_buf = ext[:, -(K - 1):] if K > 1 else buf
    return y, new_buf


def rglru_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                state: Optional[Dict]) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The Griffin recurrent block.  state: {"h": (B, W) f32, "conv": (B,
    K-1, W) bf16}, updated in place; None starts from zeros and keeps
    nothing (returned as None)."""
    keep = state is not None
    if not keep:
        state = rglru_init_state(cfg, x.shape[0], device=x.device)
    xr = x @ p["w_rec_in"]
    xg = x @ p["w_gate_in"]
    xr, conv_buf = _causal_conv(xr, p["conv_w"], state["conv"])
    y, h_last = rglru_apply(cfg, p, xr, state["h"])
    y = y * F.gelu(xg.float(), approximate="tanh").to(x.dtype)
    if not keep:
        return y @ p["w_out"], None
    state["h"].copy_(h_last)
    state["conv"].copy_(conv_buf)
    return y @ p["w_out"], state


def rglru_init_state(cfg: ModelConfig, batch: int, device="cuda") -> Dict:
    return {
        "h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.lru_width),
                            dtype=torch.bfloat16, device=device),
    }


# ================================================================== RWKV-6 ==
WKV_CHUNK = 32
_LOG_DECAY_FLOOR = -2.5  # exp(2.5·32) ≈ 5e34 stays inside f32; see _wkv_chunked


def _wkv_scan(r, k, v, w, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential WKV, one token at a time.  r, k, v, w: (B, S, H, hd)
    f32; u: (H, hd); s0: (B, H, hd, hd).  Returns (out (B, S, H, hd), the
    last state).  The inputs are split into their tokens once (``unbind``),
    so a token costs four operations: under autograd, where every one is a
    node of the graph, the host's work is what bounds the loop."""
    s = s0
    u4 = u[None, :, :, None]
    rs, ks, vs, ws = (x.unsqueeze(d).unbind(1) for x, d in ((r, -2), (k, -1), (v, -2), (w, -1)))
    outs = []
    for rt, kt, vt, wt in zip(rs, ks, vs, ws):
        kv = kt * vt                                           # (B, H, hd, hd)
        outs.append(rt @ torch.addcmul(s, u4, kv))             # (B, H, 1, hd)
        s = torch.addcmul(kv, wt, s)                           # w_t * s + kv
    return torch.stack(outs, dim=1)[:, :, :, 0], s


def _wkv_chunked(r, k, v, w, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked-parallel WKV: a scan over chunks of ``WKV_CHUNK`` tokens,
    the work inside a chunk as matmuls:

        out_t = r̃_t·S_0 + [(r̃ k̃ᵀ) ⊙ strictly-causal] v + (Σ_d r u k)·v_t
        S_L   = diag(e^{la_L})·(S_0 + k̃ᵀ v)
      with la = cumsum(log w) (per channel), r̃_t = r_t·e^{la_{t-1}},
           k̃_i = k_i·e^{-la_i}.

    The per-step log-decay is clamped to ``_LOG_DECAY_FLOOR`` so that
    e^{-la} stays finite in f32.  What does not depend on the state (la, r̃,
    k̃, the intra-chunk scores, each chunk's k̃ᵀ v) is computed for all
    chunks at once; only the state's recurrence steps chunk by chunk, two
    operations a chunk, and the state entering each chunk meets r̃ in one
    product.  Shapes as :func:`_wkv_scan`."""
    B, S, H, hd = r.shape
    L = WKV_CHUNK
    nC = S // L
    log_w = torch.minimum(torch.maximum(torch.log(torch.maximum(w, w.new_tensor(1e-38))),
                                        w.new_tensor(_LOG_DECAY_FLOOR)), w.new_tensor(0.0))

    def to_chunks(x):
        return x.reshape(B, nC, L, H, hd)

    rc, kc, vc, lwc = map(to_chunks, (r, k, v, log_w))
    bonus = torch.einsum("bshk,bshk->bsh", r * u[None, None], k)[..., None] * v
    mask = (torch.arange(L, device=r.device)[:, None]
            > torch.arange(L, device=r.device)[None, :]).float()
    la = torch.cumsum(lwc, dim=2)            # inclusive, within each chunk
    la_prev = la - lwc                       # exclusive
    r_t = rc * torch.exp(la_prev)
    k_t = kc * torch.exp(-la)
    scores = torch.einsum("bclhk,bcmhk->bchlm", r_t, k_t)
    intra = torch.einsum("bchlm,bcmhv->bclhv", scores * mask, vc)
    kv = torch.einsum("bclhk,bclhv->bchkv", k_t, vc)      # (B, nC, H, hd_k, hd_v)
    decay = torch.exp(la[:, :, -1])[..., None]             # (B, nC, H, hd_k, 1)
    s = s0
    entering = []
    for kv_c, decay_c in zip(kv.unbind(1), decay.unbind(1)):
        entering.append(s)
        s = (s + kv_c) * decay_c
    inter = torch.einsum("bclhk,bchkv->bclhv", r_t, torch.stack(entering, dim=1))
    return (inter + intra).reshape(B, S, H, hd) + bonus, s


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """The x_{t-1} stream: x shifted right by one, seeded with ``last``."""
    return torch.cat([last[:, None, :], x[:, :-1]], dim=1)


def rwkv_time_mix(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  state: Optional[Dict]) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The RWKV-6 attention analogue.  state: {"s": (B, H, hd, hd) f32,
    "x_last": (B, D)}, updated in place; None starts from zeros and keeps
    nothing (returned as None)."""
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.rwkv_head_dim
    keep = state is not None
    if not keep:
        state = rwkv_init_state(cfg, B, device=x.device)["time"]
    # the token-shift mixing runs in bf16, the WKV core in f32
    prev = _token_shift(x, state["x_last"].to(x.dtype))
    dx = prev - x

    # data-dependent token shift (ddlerp, LoRA rank rwkv_shift_lora); the
    # first LoRA product accumulates in f32 (bf16 operands, widened exactly)
    xxx = x + dx * p["mu_x"].to(x.dtype)
    lora = torch.tanh(xxx.float() @ p["shift_w1"].float())
    lora = lora.reshape(B, S, 5, cfg.rwkv_shift_lora).to(x.dtype)
    mix = torch.einsum("bskr,krd->bskd", lora, p["shift_w2"])
    mu = p["mu_rkvwg"].to(x.dtype)  # (5, D)
    xs = x[:, :, None, :] + dx[:, :, None, :] * (mu[None, None] + mix)
    xr, xk, xv, xw, xg = xs.unbind(dim=2)

    r = (xr @ p["w_r"]).reshape(B, S, H, hd)
    k = (xk @ p["w_k"]).reshape(B, S, H, hd)
    v = (xv @ p["w_v"]).reshape(B, S, H, hd)
    g = xg @ p["w_g"]

    # data-dependent decay (LoRA rank rwkv_decay_lora), in f32: it enters exp()
    wl = torch.tanh(xw.float() @ p["decay_w1"].float())
    w = p["w0"].float() + wl @ p["decay_w2"].float()
    w = torch.exp(-torch.exp(w)).reshape(B, S, H, hd)    # per-channel decay in (0, 1)
    u = p["u"].float().reshape(H, hd)

    wkv = (_wkv_chunked if cfg.rwkv_impl == "chunked" and S % WKV_CHUNK == 0 and S > 1
           else _wkv_scan)
    out, s_final = wkv(r.float(), k.float(), v.float(), w, u, state["s"].float())
    out = group_norm_heads(out, p["ln_x_scale"].float().reshape(H, hd),
                           p["ln_x_bias"].float().reshape(H, hd))
    out = out.reshape(B, S, D).to(x.dtype) * F.silu(g.float()).to(x.dtype)
    if not keep:
        return (out @ p["w_o"]).to(x.dtype), None
    state["s"].copy_(s_final)
    state["x_last"].copy_(x[:, -1])
    return (out @ p["w_o"]).to(x.dtype), state


def rwkv_channel_mix(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     state: Optional[Dict]) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The RWKV FFN (channel mix), its token shift in f32.  state:
    {"x_last": (B, D)}, updated in place; None starts from zeros and keeps
    nothing (returned as None)."""
    xf = x.float()
    last = state["x_last"] if state is not None else xf.new_zeros((x.shape[0], x.shape[2]))
    dx = _token_shift(xf, last.float()) - xf
    xk = (xf + dx * p["ffn_mu_k"].float()).to(x.dtype)
    xr = (xf + dx * p["ffn_mu_r"].float()).to(x.dtype)
    kk = torch.square(torch.relu((xk @ p["ffn_k"]).float())).to(x.dtype)
    vv = kk @ p["ffn_v"]
    rr = torch.sigmoid((xr @ p["ffn_r"]).float()).to(x.dtype)
    if state is not None:
        state["x_last"].copy_(x[:, -1])
    return vv * rr, state


def rwkv_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
               state: Optional[Dict]) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Time mix and channel mix, each behind its own RMS norm.  state:
    {"time": ..., "chan": ...} (:func:`rwkv_init_state`), updated in place;
    None starts from zeros and keeps nothing (returned as None)."""
    st_t, st_c = (None, None) if state is None else (state["time"], state["chan"])
    a, _ = rwkv_time_mix(cfg, p, rms_norm(x, p["norm1"], cfg.norm_eps), st_t)
    x = x + a
    b, _ = rwkv_channel_mix(cfg, p, rms_norm(x, p["norm2"], cfg.norm_eps), st_c)
    return x + b, state


def rwkv_init_state(cfg: ModelConfig, batch: int, device="cuda") -> Dict:
    H, hd = cfg.n_heads, cfg.rwkv_head_dim
    return {
        "time": {
            "s": torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
            "x_last": torch.zeros((batch, cfg.d_model), dtype=torch.bfloat16, device=device),
        },
        "chan": {"x_last": torch.zeros((batch, cfg.d_model), dtype=torch.bfloat16,
                                       device=device)},
    }
