"""Serving driver: init a model from a seed and run batched generation.

    python -m repro_torch.launch.serve --arch minitron-4b [--device cpu]

Runs the ``reduced()`` config of ``--arch``, as the JAX package's driver
does, on the card unless ``--device cpu`` is given.  An encoder-decoder
arch gets seeded frames of ``--prompt-len`` rows beside its prompts (the
stub frontend's output), as the JAX driver makes them.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import ARCHS
from ..kernels import resolve_device
from ..models.registry import get_model
from ..serving.engine import ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="minicpm-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = ARCHS[args.arch].reduced()
    bundle = get_model(cfg)
    params = bundle.init(torch.Generator(device=device).manual_seed(0), device=device)
    engine = ServeEngine(
        bundle, params,
        max_len=args.prompt_len + args.max_new_tokens,
        batch=args.batch, temperature=args.temperature, device=device,
    )
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)}
    if cfg.is_encdec:
        batch["frames"] = rng.randn(args.batch, args.prompt_len, cfg.d_model).astype(np.float32)
    res = engine.generate(batch, max_new_tokens=args.max_new_tokens)
    tps = res.steps * args.batch / max(res.decode_s, 1e-9)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    print(f"[serve] {args.arch}: prefill {res.prefill_s*1e3:.1f}ms, "
          f"{res.steps} decode steps, {tps:.1f} tok/s ({where}, reduced config)")
    print("[serve] sample tokens:", res.tokens[0, :12].tolist())


if __name__ == "__main__":
    main()
