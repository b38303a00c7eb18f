"""Where Phi-3.5-MoE's 2048-token prefill parts from its teacher forcing.

Not a pytest module (it needs a CUDA card and about 60 GB of it): run it by
hand on the GPU machine, from the repo root,

    PYTHONPATH=src python tests/torch_moe_prefill_gap_check.py

It draws ``chip_smoke.py``'s phase (n) model (phi3.5-moe-42b-a6.6b at its
published widths, 16 layers, same seed), prefills one batch of 4 random
2048-token prompts through the bundle drop-free (the dispatch, the flash
kernel), and runs teacher forcing on the prefill's routes (each MoE layer
``moe_block_plain``) over the prompt as it is and padded to 2560 tokens.
For each layer it prints where the teachers part from the prefill: the
attention's output and the MoE layer's input and output, over the 2048
prompt positions.  Then, on the first layer's own inputs, each op alone:
the flash kernel at 2048 against at 2560 (the first 2048 rows), and
``moe_block`` against ``moe_block_plain`` at 4 x 2048 tokens and at 1 x
1024 (the layer check's size).
"""

import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from repro_torch.models import attention, get_model, moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

B, S, PADDED = 4, 2048, 2560


class Record:
    """While active, keeps every attention's (q, k, v, out) and every MoE
    layer's (in, out), first S positions, in call order."""

    def __enter__(self):
        self.attn, self.moe = [], []
        self._saved = attention._full_attention, moe.moe_block, moe.moe_block_plain
        full, block, plain = self._saved

        def attend(q, k, v, *, causal):
            o = full(q, k, v, causal=causal)
            self.attn.append(tuple(t[:, :S].clone() for t in (q, k, v, o)))
            return o

        def wrap(fn):
            def run(cfg, p, x):
                y = fn(cfg, p, x)
                self.moe.append((x[:, :S].clone(), y[:, :S].clone()))
                return y
            return run

        attention._full_attention = attend
        moe.moe_block, moe.moe_block_plain = wrap(block), wrap(plain)
        return self

    def __exit__(self, *exc):
        attention._full_attention, moe.moe_block, moe.moe_block_plain = self._saved


def gap(got, want) -> str:
    d = (got.float() - want.float()).abs()
    return f"max abs {float(d.max()):.6f} ({int((d > 0).sum())} of {d.numel()} differ)"


def main() -> None:
    cfg, params = cs.moe_model(cs.PHI_ARCH, cs.PHI_LAYERS, "n")
    free = cs.drop_free(cfg)
    bundle = get_model(free)
    tokens = torch.randint(0, cfg.vocab, (B, S), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(cs.SEED))
    with torch.no_grad():
        cache = bundle.init_cache(B, S + 16, device="cuda")
        with Record() as engine, cs.RouteLog() as rl:
            bundle.prefill(params, {"tokens": tokens}, cache)
        del cache
        teachers = {}
        for length in (S, PADDED):
            padded = F.pad(tokens, (0, length - S))
            with cs.ForcedRoutes(list(rl.calls)), Record() as rec:
                tf.forward_hidden(free, params, padded)
            teachers[length] = rec
        for length, rec in teachers.items():
            print(f"teacher over {length} tokens against the prefill (first {S} positions):")
            for i, (a, b, c, d) in enumerate(zip(engine.attn, rec.attn, engine.moe, rec.moe)):
                print(f"  layer {i}: attention out {gap(b[3], a[3])}; MoE in {gap(d[0], c[0])}; "
                      f"MoE out {gap(d[1], c[1])}", flush=True)

        q, k, v, o = engine.attn[0]
        pad = [F.pad(t, (0, 0, 0, 0, 0, PADDED - S)) for t in (q, k, v)]
        long = attention._full_attention(*pad, causal=True)[:, :S]
        print(f"layer 0 flash kernel, 2560 against 2048 on the same rows: {gap(long, o)}")
        p, x = cs.moe_layer_input(free, params, tokens[:1, :128])[0], engine.moe[0][0]
        print(f"layer 0 moe_block against moe_block_plain at {B} x {S}: "
              f"{gap(moe.moe_block(free, p, x), moe.moe_block_plain(free, p, x))}")
        x1 = x[:1, :1024]
        print(f"layer 0 moe_block against moe_block_plain at 1 x 1024: "
              f"{gap(moe.moe_block(free, p, x1), moe.moe_block_plain(free, p, x1))}")


if __name__ == "__main__":
    main()
