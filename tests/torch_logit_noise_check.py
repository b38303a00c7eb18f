"""How far apart two bf16 evaluations of full-depth minitron-4b are.

Not a pytest module (it needs a CUDA card and about 30 GB of it): run it by
hand on the GPU machine,

    PYTHONPATH=src python tests/torch_logit_noise_check.py

It draws minitron-4b's weights on the card as ``chip_smoke.py``'s phase (h)
does (same seed) and, for one batch of 8 random 2048-token prompts, prints
the logits at the last prompt position of

* the prefill (the flash kernel) against teacher forcing over the prompt
  through the same route, and through the chunked softmax;
* one decode step against teacher forcing over the prompt and one token;
* both bf16 routes against an f32 evaluation of the same bf16 weights
  (chunked softmax, f32 products);

and the relative gap of the last position's hidden state between the two
routes after every fourth layer.  Each line gives the max and mean abs
difference and the ``allclose`` ratio at rtol = atol = 2e-2 (the
reference test's prefill tolerance): the worst |got - want| / (2e-2 +
2e-2 |want|), which must be <= 1 to pass.
"""

import sys
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.models import attention, get_model
from repro_torch.models import transformer as tf
from repro_torch.models.layers import chunked_attention

SEED = 1505_05211  # chip_smoke.py's
B, S = 8, 2048


def chunked_route(q, k, v, *, causal):
    return chunked_attention(q, k, v, causal=causal)


def report(name, got, want) -> None:
    got, want = got.float(), want.float()
    d = (got - want).abs()
    ratio = float((d / (2e-2 + 2e-2 * want.abs())).max())
    print(f"{name}: max abs {float(d.max()):.6f} mean abs {float(d.mean()):.6f} "
          f"allclose ratio {ratio:.3f} (logit std {float(want.std()):.4f})", flush=True)


def logits_at(cfg, params, tokens, pos, *, chunked=False):
    """Teacher-forcing logits at ``pos`` over ``tokens``, by either route."""
    full = attention._full_attention
    if chunked:
        attention._full_attention = chunked_route
    try:
        hidden, _ = tf.forward_hidden(cfg, params, tokens)
    finally:
        attention._full_attention = full
    return tf.lm_logits(cfg, params, hidden[:, pos:pos + 1])[:, 0].float()


def last_hidden_by_layer(cfg, params, tokens, *, chunked):
    full = attention._full_attention
    if chunked:
        attention._full_attention = chunked_route
    out = []
    try:
        x = tf.embed_tokens(cfg, params, tokens)
        stack = params["segments"][0][0]
        for r in range(cfg.n_layers):
            x, _ = tf.block_apply(cfg, "attn", False, tf._layer(stack, r), x, mode="train")
            out.append(x[:, -1].float().clone())
    finally:
        attention._full_attention = full
    return out


def to_f32(tree):
    if isinstance(tree, dict):
        return {k: to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_f32(v) for v in tree]
    return tree.float()


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_logit_noise_check: needs a CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    cfg = ARCHS["minitron-4b"]
    bundle = get_model(cfg)
    params = bundle.init(torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    rng = np.random.default_rng(SEED)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)), device="cuda")
    print(f"{torch.cuda.get_device_name(0)}; minitron-4b, B {B}, prompt {S}", flush=True)
    with torch.no_grad():
        cache = bundle.init_cache(B, S + 8, device="cuda")
        pre, cache = bundle.prefill(params, {"tokens": prompt}, cache)
        pre = pre[:, 0].float()
        flash = logits_at(cfg, params, prompt, S - 1)
        chunk = logits_at(cfg, params, prompt, S - 1, chunked=True)
        report("prefill vs teacher forcing, same route (flash)", pre, flash)
        report("prefill vs teacher forcing, chunked route", pre, chunk)
        nxt = pre.argmax(-1)[:, None]
        dec, _ = bundle.decode_step(params, nxt, cache, S)
        ext = torch.cat([prompt, nxt], 1)  # S + 1 tokens: the chunked route
        report("decode step vs teacher forcing over S + 1", dec[:, 0],
               logits_at(cfg, params, ext, S))
        a = last_hidden_by_layer(cfg, params, prompt, chunked=False)
        b = last_hidden_by_layer(cfg, params, prompt, chunked=True)
        for i in list(range(0, cfg.n_layers, 4)) + [cfg.n_layers - 1]:
            rel = float((a[i] - b[i]).norm() / b[i].norm())
            print(f"layer {i}: hidden rms {float(b[i].pow(2).mean().sqrt()):.4f}, flash vs "
                  f"chunked relative gap {rel:.5f}", flush=True)
        del a, b, cache
        params32 = to_f32(params)
        del params
        torch.cuda.empty_cache()
        # the same bf16 weights and embeddings, f32 arithmetic throughout
        x = params32["embed"][prompt]
        attention._full_attention, full = chunked_route, attention._full_attention
        try:
            x, _ = tf._run_segments(cfg, params32, x, mode="train")
        finally:
            attention._full_attention = full
        truth = tf.lm_logits(cfg, params32, x[:, -1:])[:, 0].float()
        report("prefill (bf16, flash) vs f32", pre, truth)
        report("teacher forcing (bf16, chunked) vs f32", chunk, truth)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
