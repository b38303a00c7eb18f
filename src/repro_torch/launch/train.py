"""End-to-end training driver with versioned fault-tolerant checkpointing,
as ``repro.launch.train`` has it, on the card.

    python -m repro_torch.launch.train --arch minicpm-2b [--full-config] [--device cpu]

The loop:

* resume: restore (params, optimizer, data-iterator state) from the newest
  version in the store, onto the run's device;
* run: the eager train step, which updates the state in place (where JAX
  jits a step with a donated state); batches go up through pinned memory;
* checkpoint: an async versioned delta commit every ``save_every`` steps;
* preemption: the guard flips on SIGTERM; the loop saves synchronously and
  exits 42 (the launcher's "restart me" code);
* repack: every ``repack_every`` saves, re-optimize the storage graph with
  the paper's solver (Problem 6 with the restore-latency SLA θ), on the card.

It trains the dense decoder configs, the MoE and MLA families (DeepSeek-V3
with its MTP loss, Phi-3.5-MoE) and the recurrent families
(RecurrentGemma-9B, RWKV-6 3B: the RG-LRU's and the WKV's f32 vectors are
saved and restored as f32).  The enc-dec family raises before anything is
drawn: the JAX package's driver feeds the step from its token pipeline,
whose batches carry no frames, so it cannot train that family either; the
family trains through ``training.make_train_step`` on batches that carry
frames.  It runs on the card; ``device="cpu"`` (``--device cpu``) runs the
plain PyTorch versions, at the reduced configs the JAX package's examples
use.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..checkpoint import PreemptionGuard, VersionedCheckpointManager
from ..configs import ARCHS
from ..data.pipeline import SyntheticTokenPipeline
from ..kernels import resolve_device
from ..models import transformer as tf
from ..models.registry import get_model
from ..training.optimizer import OptimizerConfig, init_opt_state
from ..training.train_loop import TrainConfig, make_train_step


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class RunConfig:
    arch: str = "minicpm-2b"
    reduced: bool = True
    steps: int = 50
    seq_len: int = 128
    global_batch: int = 8
    save_every: int = 10
    repack_every: int = 0
    max_restore_cost_s: float = 60.0
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    seed: int = 0
    schedule: str = "cosine"
    grad_accum: int = 1
    compress_grads: bool = False


def run_model_config(run: RunConfig):
    return ARCHS[run.arch].reduced() if run.reduced else ARCHS[run.arch]


def train_config(run: RunConfig) -> TrainConfig:
    """The train step's config for ``run``: the JAX driver's (peak lr 1e-3,
    10 warm-up steps, the schedule over the run's steps)."""
    return TrainConfig(
        optimizer=OptimizerConfig(
            peak_lr=1e-3, schedule=run.schedule, warmup_steps=10,
            total_steps=run.steps,
        ),
        grad_accum=run.grad_accum,
        compress_grads=run.compress_grads,
    )


def state_template(cfg) -> Dict[str, Any]:
    """The saved state's structure as ``(shape, dtype)`` leaves, from the
    config's shapes alone: nothing is allocated.  Each param keeps its own
    dtype (bf16; f32 for the MoE routers and the recurrent blocks' vectors:
    the RG-LRU's gates and Λ, RWKV-6's ``mu_x``, ``mu_rkvwg``, ``w0``, ``u``,
    ``ln_x_*`` and ``ffn_mu_*``) and the MTP head's subtree is there when
    the config has one; the moments are f32."""
    scalar = ((), torch.int32)
    moments = tf.param_shapes(cfg, torch.float32)
    return {
        "params": tf.param_shapes(cfg),
        "opt": {"mu": moments, "nu": moments, "step": scalar},
        "data": {"step": scalar, "epoch": scalar},
    }


def train(run: RunConfig, *, guard: Optional[PreemptionGuard] = None,
          log_every: int = 10, device="cuda") -> Dict[str, Any]:
    """Train ``run`` on ``device`` (the card; it raises without one unless
    ``device="cpu"``).  Returns the JAX driver's result (``losses``,
    ``preempted``, ``steps_done``, ``wall_s``, ``manager``, ``final_state``,
    ``pipe``, ``bundle``) plus ``lrs``, ``grad_norms`` and ``step_s``: each
    step's time, read on the device's clock (CUDA events, the end of one step
    to the end of the next; the first from the loop's start) on the card and
    on the host's clock on the CPU."""
    device = resolve_device(device)
    cfg = run_model_config(run)
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the driver draws its batches from SyntheticTokenPipeline, a "
            "token-only pipeline (as the JAX package's driver does), and an encoder-decoder "
            "batch carries frames; train it through training.make_train_step on a batch "
            "with frames")
    bundle = get_model(cfg)
    step_fn = make_train_step(bundle, train_config(run))

    pipe = SyntheticTokenPipeline(
        vocab=cfg.vocab, seq_len=run.seq_len, global_batch=run.global_batch,
        seed=run.seed, device=device,
    )
    mgr = VersionedCheckpointManager(
        run.ckpt_dir, max_restore_cost_s=run.max_restore_cost_s, device=device,
    )
    guard = guard or PreemptionGuard()

    # ---- resume or init -----------------------------------------------------
    start_step = 0
    if mgr.latest_step() is not None:
        full = mgr.restore(template=state_template(cfg))
        state = {"params": full["params"], "opt": full["opt"], "error_fb": None}
        pipe.restore({k: int(v) for k, v in full["data"].items()})
        start_step = mgr.latest_step() + 1
        print(f"[train] resumed from step {start_step - 1} "
              f"(restore cost {mgr.restore_cost_s():.3f}s modelled)")
    else:
        params = bundle.init(torch.Generator(device=device).manual_seed(run.seed),
                             device=device)
        state = {"params": params, "opt": init_opt_state(params), "error_fb": None}

    # ---- loop ---------------------------------------------------------------
    on_card = device.type == "cuda"
    clock = (lambda: _event(device)) if on_card else time.perf_counter
    history = []
    marks = [clock()]
    t_start = time.monotonic()
    preempted = False
    for step in range(start_step, run.steps):
        batch = pipe.next_batch()
        state, metrics = step_fn(state, batch)
        history.append(metrics)
        marks.append(clock())
        if step % log_every == 0 or step == run.steps - 1:
            print(f"[train] step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f}")
        if guard.preempted:
            snap = pipe.snapshot()
            mgr.emergency_save(step, _save_state(state, snap))
            print(f"[train] PREEMPTED at step {step}: emergency checkpoint saved")
            preempted = True
            break
        if run.save_every and (step + 1) % run.save_every == 0:
            mgr.save(step, _save_state(state, pipe.snapshot()))
            if run.repack_every and ((step + 1) // run.save_every) % run.repack_every == 0:
                stats = mgr.repack()
                print(f"[train] repack: {stats['before']['storage_bytes']/1e6:.1f}MB "
                      f"-> {stats['after']['storage_bytes']/1e6:.1f}MB, "
                      f"max restore {stats['after']['max_recreation_s']:.3f}s")
    mgr.wait()
    if on_card:
        marks[-1].synchronize()
        step_s = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
    else:
        step_s = [b - a for a, b in zip(marks, marks[1:])]
    wall = time.monotonic() - t_start
    # the host reads the metrics once, here
    read = lambda key: (torch.stack([m[key] for m in history]).tolist() if history else [])
    return {
        "losses": read("loss"),
        "lrs": read("lr"),
        "grad_norms": read("grad_norm"),
        "step_s": step_s,
        "preempted": preempted,
        "steps_done": len(history),
        "wall_s": wall,
        "manager": mgr,
        "final_state": state,
        "pipe": pipe,
        "bundle": bundle,
    }


def _event(device: torch.device) -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _save_state(state, data_snap) -> Dict[str, Any]:
    return {
        "params": state["params"],
        "opt": state["opt"],
        "data": {
            "step": np.int32(data_snap["step"]),
            "epoch": np.int32(data_snap["epoch"]),
        },
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="minicpm-2b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=_default_ckpt_dir())
    ap.add_argument("--full-config", action="store_true",
                    help="use the full config instead of reduced")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run = RunConfig(
        arch=args.arch, reduced=not args.full_config, steps=args.steps,
        seq_len=args.seq_len, global_batch=args.global_batch,
        save_every=args.save_every, ckpt_dir=args.ckpt_dir,
        grad_accum=args.grad_accum, compress_grads=args.compress_grads,
    )
    guard = PreemptionGuard(install_signal_handlers=True)
    out = train(run, guard=guard, device=args.device)
    out["manager"].close()
    print(f"[train] done: {out['steps_done']} steps in {out['wall_s']:.1f}s, "
          f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}")
    raise SystemExit(42 if out["preempted"] else 0)


if __name__ == "__main__":
    main()
