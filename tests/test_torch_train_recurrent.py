"""Training the recurrent families: the port against the JAX package, on the
CPU.  RecurrentGemma-9B (RG-LRU through the associative scan, windowed GQA
through the block-local softmax) and RWKV-6 3B (the WKV scan and its chunked
form), reduced, S = 64 (two attention windows, two WKV chunks).

Both packages compute from the same numpy inputs made from a seed; the JAX
package draws the weights and ``train_state_from_numpy`` /
``params_from_numpy`` carry them into the port.  Tolerances, stated where
they are used, with the readings they were set from:

* **The scan's backward** (``_rglru_scan``, f32, h0 folded in): every
  gradient within ``SCAN_GRAD_TOL`` = 1e-6 of ``jax.grad`` through
  ``jax.lax.associative_scan``, as ``||d|| / ||ref||``: the forward is bit
  for bit, the transposed products run in another order (readings 0 at
  S = 1, at most 5.4e-8 at S = 7, 40, 64).
* **Layer backwards**, each leaf's ``||d|| / ||ref||`` against ``jax.grad``
  of the JAX layer: ``rglru_apply`` with a non-zero h0 (f32 math on a bf16
  input) under ``RGLRU_GRAD_TOL`` = 1e-4 (readings 2.5e-7 at Λ in a fresh
  process, bit-identical across processes on both sides; in 2 of about 10
  runs under pytest-xdist's 6 workers, 1.8e-5-1.9e-5 on the leaves that
  reach the scan through a (a_gate, a_gate_bias, Λ), after other tests ran
  in the same worker: which side moved is not pinned down);
  ``rwkv_time_mix`` in both forms from a zero state, as training runs it,
  under ``TIME_MIX_GRAD_TOL`` = 2.5e-2 (readings at most 1.32e-2, at mu_x,
  in both forms: its bf16 token-shift chain, which XLA's CPU keeps in f32
  where the port rounds each op).  The planted faults land above: the h0
  fold dropped (h0's gradient 1.0, the gates' and Λ's up to 0.20) and the
  WKV bonus dropped (u's gradient 1.0, mu_x's 0.038).
* **The two WKV forms**: the chunked form's gradients within
  ``FORMS_GRAD_TOL`` = 5e-3 of the scan's, both in the port on the same
  layer (readings at most 1.42e-3, at mu_x: f32 differences of the forms
  that flip a bf16 rounding; the bonus fault 1.0 on u, 0.037 on mu_x).
* **The tie rule**: a decay of exactly 1.0 (log-decay 0, the top of the
  chunked form's clip) gets half the gradient of a decay one ulp under it,
  as ``jnp.clip`` gives it, and equals ``jax.grad``'s within 1e-5.
* **One train step** of each arch against JAX's jitted ``make_train_step``
  with ``hold_step`` (tests/test_torch_training.py), counting an element only
  when it is off by a hundredth of a step (the f32 vectors keep the f32
  rounding of an update), and every leaf's gradient within
  ``MODEL_GRAD_TOL`` = 6e-2 of ``jax.grad``'s (readings: RecurrentGemma at
  most 1.45e-2, at a conv_w; RWKV-6 at most 3.19e-2 (scan, u) and 3.28e-2
  (chunked, mu_x): XLA's CPU keeps bf16 elementwise chains in f32 where the
  port rounds each op, and RWKV's forward hidden states already part by
  1.3e-2).  The loss is held at 1e-3 (readings at most 1.2e-5).  RWKV-6's
  grad norm is held at ``RWKV_NORM_RTOL`` = 2**-8, one bf16 unit roundoff
  (readings 1.72e-3 scan, 1.18e-3 chunked; RecurrentGemma's 1.1e-5 at
  1e-3), and the share of its elements off by more than a hundredth of a
  step at ``RWKV_SHARE`` = 4% (readings 2.30% at mu_rkvwg, 2.03% of the
  small leaves); RecurrentGemma's f32 vectors (Λ, the gates), whose
  gradients lie near Adam's eps = 1e-8, move by a fraction of a step in up
  to ``RG_SHARE`` = 10% of the small leaves' elements (reading 6.6%; its
  larger leaves at most 0.94%).
* **Remat** changes no gradient bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import recurrent as jax_rec
from repro.models import transformer as jax_tf
from repro_torch.configs import ARCHS
from repro_torch.launch import train as train_mod
from repro_torch.launch.train import RunConfig, train
from repro_torch.models import get_model
from repro_torch.models import recurrent as port_rec
from repro_torch.models import transformer as port_tf
from repro_torch.models.convert import params_from_numpy, train_state_to_numpy
from repro_torch.training import train_loop as port_tl
from repro_torch.tree import tree_leaves, tree_paths
from test_torch_train_driver import PreemptAt
from test_torch_training import hold_step
from torch_train_parity import hold_grads, jax_reference, port_grads, port_step, rel

RG, RWKV = "recurrentgemma-9b", "rwkv6-3b"
CASES = [(RG, "scan"), (RWKV, "scan"), (RWKV, "chunked")]
B, S = 2, 64
SCAN_GRAD_TOL = 1e-6
RGLRU_GRAD_TOL = 1e-4
TIME_MIX_GRAD_TOL = 2.5e-2
FORMS_GRAD_TOL = 5e-3
MODEL_GRAD_TOL = 6e-2
RWKV_NORM_RTOL = 2.0 ** -8
RG_SHARE = 0.1
RWKV_SHARE = 0.04
RGLRU_LEAVES = ("a_gate", "a_gate_bias", "i_gate", "i_gate_bias", "lambda")
TIME_MIX_LEAVES = ("mu_x", "mu_rkvwg", "shift_w1", "shift_w2", "w_r", "w_k", "w_v", "w_g",
                   "w_o", "w0", "decay_w1", "decay_w2", "u", "ln_x_scale", "ln_x_bias")


def configs(arch, impl="scan"):
    return (dataclasses.replace(JAX_ARCHS[arch].reduced(), rwkv_impl=impl),
            dataclasses.replace(ARCHS[arch].reduced(), rwkv_impl=impl))


def bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def torch_grads(fn, inputs: dict, cots) -> dict:
    """Gradients of ``sum(out_i * cot_i)`` (f32) over ``fn(**inputs)``'s
    outputs, by input name; an input the output does not reach gets zeros
    (where a planted fault cuts it off)."""
    leaves = {k: params_from_numpy(v, device="cpu").requires_grad_(True)
              for k, v in inputs.items()}
    outs = fn(**leaves)
    total = sum((o.float() * torch.from_numpy(np.asarray(c, np.float32))).sum()
                for o, c in zip(outs, cots))
    grads = torch.autograd.grad(total, list(leaves.values()), allow_unused=True,
                                materialize_grads=True)
    return {k: g.float().numpy() for k, g in zip(leaves, grads)}


def jax_grads(fn, inputs: dict, cots) -> dict:
    def f(inp):
        outs = fn(**inp)
        return sum(jnp.sum(o.astype(jnp.float32) * jnp.asarray(c, jnp.float32))
                   for o, c in zip(outs, cots))

    g = jax.jit(jax.grad(f))({k: jnp.asarray(v) for k, v in inputs.items()})
    return {k: np.asarray(v, np.float32) for k, v in g.items()}


# ------------------------------------------------------------- the RG-LRU
@pytest.mark.parametrize("n", [1, 7, 40, 64])
def test_rglru_scan_backward_matches_jax(n):
    """``_assoc_scan``'s odd/even recursion and ``_fma``'s f64 multiply-add,
    differentiated by autograd, against ``jax.grad`` through
    ``jax.lax.associative_scan``: the gradients of a, bx and h0 (the h0
    fold) within ``SCAN_GRAD_TOL``."""
    rng = np.random.RandomState(n)
    inputs = {"a": rng.uniform(0.5, 1.0, (B, n, 24)).astype(np.float32),
              "bx": rng.randn(B, n, 24).astype(np.float32),
              "h0": rng.randn(B, 24).astype(np.float32)}
    cots = [rng.randn(B, n, 24), rng.randn(B, 24)]
    got = torch_grads(port_rec._rglru_scan, inputs, cots)
    want = jax_grads(jax_rec._rglru_scan, inputs, cots)
    hold_grads(got, want, SCAN_GRAD_TOL)


def _h0_fold_dropped(a, bx, h0):
    """A planted fault: the scan without h0 folded into its first step."""
    _, hh = port_rec._assoc_scan(a, bx)
    return hh, hh[:, -1]


@pytest.fixture(scope="module")
def rglru_case():
    cfg_j, cfg_t = configs(RG)
    p = jax.tree.map(np.asarray, jax_tf.block_init(cfg_j, "rglru", False,
                                                   jax.random.PRNGKey(7)))
    rng = np.random.RandomState(1)
    W = cfg_t.lru_width
    inputs = {**{k: p[k] for k in RGLRU_LEAVES}, "x": bf16(rng.randn(B, S, W)),
              "h0": rng.randn(B, W).astype(np.float32)}
    cots = [bf16(rng.randn(B, S, W)), rng.randn(B, W)]
    want = jax_grads(lambda x, h0, **p_: jax_rec.rglru_apply(cfg_j, p_, x, h0), inputs, cots)
    return cfg_t, inputs, cots, want


@pytest.mark.parametrize("fault", [None, "h0 fold dropped"])
def test_rglru_apply_backward_matches_jax(rglru_case, monkeypatch, fault):
    """The RG-LRU layer's gradients (x, h0, the gates and Λ) against
    ``jax.grad`` of the JAX layer, within ``RGLRU_GRAD_TOL``; with the h0
    fold dropped (a planted fault) the comparison fails."""
    cfg_t, inputs, cots, want = rglru_case
    if fault:
        monkeypatch.setattr(port_rec, "_rglru_scan", _h0_fold_dropped)
    got = torch_grads(lambda x, h0, **p_: port_rec.rglru_apply(cfg_t, p_, x, h0), inputs, cots)
    if fault:
        assert rel(got["h0"], want["h0"]) == 1.0
        assert max(rel(got[k], want[k]) for k in RGLRU_LEAVES) > 1e3 * RGLRU_GRAD_TOL
        return
    assert all(np.abs(g).max() > 0 for g in got.values())
    hold_grads(got, want, RGLRU_GRAD_TOL)


# ------------------------------------------------------------------- the WKV
def _no_bonus(fn):
    return lambda r, k, v, w, u, s0: fn(r, k, v, w, torch.zeros_like(u), s0)


@pytest.fixture(scope="module")
def time_mix_case():
    """One RWKV-6 time mix's params, a bf16 input and cotangent, and
    ``jax.grad`` of the JAX layer from a zero state in each form."""
    cfg_j, _ = configs(RWKV)
    p = jax.tree.map(np.asarray, jax_tf.block_init(cfg_j, "rwkv", False,
                                                   jax.random.PRNGKey(7)))
    rng = np.random.RandomState(2)
    inputs = {**{k: p[k] for k in TIME_MIX_LEAVES}, "x": bf16(rng.randn(B, S, cfg_j.d_model))}
    cots = [bf16(rng.randn(B, S, cfg_j.d_model))]
    want = {}
    for impl in ("scan", "chunked"):
        cj, _ = configs(RWKV, impl)
        zero = jax_rec.rwkv_init_state(cj, B)["time"]
        want[impl] = jax_grads(lambda x, **p_: jax_rec.rwkv_time_mix(cj, p_, x, zero)[:1],
                               inputs, cots)
    return inputs, cots, want


def port_time_mix_grads(impl, inputs, cots) -> dict:
    _, cfg_t = configs(RWKV, impl)
    return torch_grads(lambda x, **p_: port_rec.rwkv_time_mix(cfg_t, p_, x, None)[:1],
                       inputs, cots)


@pytest.mark.parametrize("fault", [None, "bonus dropped"])
@pytest.mark.parametrize("impl", ["scan", "chunked"])
def test_rwkv_time_mix_backward_matches_jax(time_mix_case, monkeypatch, impl, fault):
    """The time mix's gradients (x and all fifteen leaves, the f32 ones
    among them) against ``jax.grad`` of the JAX layer in the same form,
    within ``TIME_MIX_GRAD_TOL``; with the bonus term dropped (a planted
    fault) the comparison fails, on u and on the leaves it feeds."""
    inputs, cots, want = time_mix_case
    if fault:
        name = "_wkv_chunked" if impl == "chunked" else "_wkv_scan"
        monkeypatch.setattr(port_rec, name, _no_bonus(getattr(port_rec, name)))
    got = port_time_mix_grads(impl, inputs, cots)
    if fault:
        assert rel(got["u"], want[impl]["u"]) == 1.0
        assert max(rel(got[k], want[impl][k]) for k in want[impl] if k != "u") > \
            TIME_MIX_GRAD_TOL
        return
    assert all(np.abs(g).max() > 0 for g in got.values())
    hold_grads(got, want[impl], TIME_MIX_GRAD_TOL)


def test_wkv_forms_grads_agree(time_mix_case, monkeypatch):
    """The chunked form's gradients against the scan's, both in the port,
    on the same layer: within ``FORMS_GRAD_TOL``; the chunked form with its
    bonus dropped lands above it."""
    inputs, cots, _ = time_mix_case
    scan = port_time_mix_grads("scan", inputs, cots)
    hold_grads(port_time_mix_grads("chunked", inputs, cots), scan, FORMS_GRAD_TOL)
    monkeypatch.setattr(port_rec, "_wkv_chunked", _no_bonus(port_rec._wkv_chunked))
    faulty = port_time_mix_grads("chunked", inputs, cots)
    assert rel(faulty["u"], scan["u"]) == 1.0
    assert max(rel(faulty[k], scan[k]) for k in scan if k != "u") > FORMS_GRAD_TOL


def test_wkv_decay_of_one_takes_jaxs_tie_gradient():
    """At a decay of exactly 1.0 the chunked form's log-decay sits on the top
    of its clip (0), where ``jnp.clip`` hands each side half of the
    gradient (``torch.clamp`` would pass all of it).  The port's gradient
    there is half that of a decay one f32 ulp under 1.0, inside the range,
    and equals ``jax.grad``'s."""
    rng = np.random.RandomState(3)
    H, hd = 2, 8
    shape = (1, 32, H, hd)
    inputs = {"r": rng.randn(*shape), "k": rng.randn(*shape), "v": rng.randn(*shape),
              "w": rng.uniform(0.5, 0.95, shape), "u": rng.randn(H, hd),
              "s0": rng.randn(1, H, hd, hd)}
    inputs = {k: v.astype(np.float32) for k, v in inputs.items()}
    planted = np.zeros(shape, bool)
    planted[0, ::3, :, ::2] = True
    inputs["w"][planted] = 1.0
    cots = [rng.randn(*shape), rng.randn(1, H, hd, hd)]
    got = torch_grads(port_rec._wkv_chunked, inputs, cots)["w"]
    want = jax_grads(jax_rec._wkv_chunked, inputs, cots)["w"]
    np.testing.assert_allclose(got[planted], want[planted], rtol=1e-5, atol=1e-6)
    under = dict(inputs, w=np.where(planted, np.nextafter(np.float32(1), np.float32(0)),
                                    inputs["w"]).astype(np.float32))
    full = torch_grads(port_rec._wkv_chunked, under, cots)["w"]
    np.testing.assert_allclose(got[planted], 0.5 * full[planted], rtol=1e-4, atol=1e-6)
    assert np.abs(got[planted]).min() > 0


# ------------------------------------------------------------ one train step
@pytest.mark.parametrize("arch,impl", CASES)
def test_one_step_matches_jax(arch, impl):
    """One train step of reduced RecurrentGemma-9B and RWKV-6 3B (both WKV
    forms) against JAX's jitted step, from the JAX package's weights, and
    every leaf's gradient against ``jax.grad``'s: every RG-LRU, attention
    and WKV leaf gets a non-zero one."""
    cfg_j, cfg_t = configs(arch, impl)
    tokens = np.random.RandomState(7).randint(0, 512, (B, S)).astype(np.int32)
    ref = jax_reference(cfg_j, {"tokens": tokens})
    got, got_m = port_step(cfg_t, ref["state0"], {"tokens": tokens})
    hold_step(got, ref["state1"], got_m, ref["metrics"], moe=True,
              norm_rtol=RWKV_NORM_RTOL if arch == RWKV else 1e-3,
              share=RG_SHARE if arch == RG else RWKV_SHARE)
    grads = port_grads(cfg_t, ref["state0"], {"tokens": tokens})
    hold_grads(grads, ref["grads"], MODEL_GRAD_TOL)
    assert all(np.abs(g).max() > 0 for g in grads.values())
    names = {k.rsplit("/", 1)[-1] for k in grads}
    assert (set(RGLRU_LEAVES) | {"wq", "wk", "conv_w"} <= names if arch == RG
            else set(TIME_MIX_LEAVES) <= names)


# ------------------------------------------------------------------- remat
def _no_remat(fn, *args, use_reentrant=None, preserve_rng_state=None):
    return fn(*args)


@pytest.mark.parametrize("arch,impl", CASES)
def test_remat_changes_no_gradient(arch, impl, monkeypatch):
    """Each rglru, rwkv and windowed attn layer recomputes in the backward
    pass exactly what its forward computed: every leaf's gradient with the
    layers rematerialised equals, bit for bit, its gradient with them run
    once and kept.  The run without remat also shows that a layer without a
    state writes none: a write into the WKV's zero s0, which autograd keeps,
    would fail that backward's version check."""
    _, cfg = configs(arch, impl)
    bundle = get_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(3), device="cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    batch = {"tokens": torch.from_numpy(
        np.random.RandomState(4).randint(0, cfg.vocab, (B, S))).long()}
    loss_fn = port_tl.make_loss_fn(bundle, port_tl.TrainConfig())
    remat = torch.autograd.grad(loss_fn(params, batch), leaves)
    monkeypatch.setattr(port_tf, "checkpoint", _no_remat)
    once = torch.autograd.grad(loss_fn(params, batch), leaves)
    for (k, _), a, b in zip(tree_paths(params), remat, once):
        assert torch.equal(a, b), k


# ------------------------------------------------------------------ the driver
@pytest.mark.parametrize("arch", [RG, RWKV])
def test_driver_trains_with_preemption_and_resume(tmp_path, arch):
    """``launch.train.train`` trains reduced RecurrentGemma-9B and RWKV-6 3B
    (their WKV scan, the config's default) through saves, a preemption and
    a resume.  The emergency save comes back leaf for leaf, bit for bit,
    every f32 leaf (the RG-LRU's gates and Λ, RWKV's mu_x, mu_rkvwg, w0, u,
    ln_x_* and ffn_mu_*) as f32, and the run ends where an uninterrupted
    stream would."""
    common = dict(arch=arch, reduced=True, steps=6, seq_len=S, global_batch=B,
                  save_every=2, ckpt_dir=str(tmp_path), max_restore_cost_s=30.0)
    out1 = train(RunConfig(**common), guard=PreemptAt(at=3), log_every=100, device="cpu")
    assert out1["preempted"] and out1["steps_done"] == 3
    mgr = out1["manager"]
    saved = train_state_to_numpy({k: out1["final_state"][k] for k in ("params", "opt")})
    restored = train_state_to_numpy(mgr.restore(train_mod.state_template(
        train_mod.run_model_config(RunConfig(**common)))))
    restored = {"params": restored["params"], "opt": restored["opt"]}
    f32 = set()
    for (k, a), (k2, b) in zip(tree_paths(saved), tree_paths(restored)):
        assert k == k2 and a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
        if k.startswith("params/") and a.dtype == np.float32:
            f32.add(k.rsplit("/", 1)[-1])
    assert f32 == (set(RGLRU_LEAVES) if arch == RG else
                   {"mu_x", "mu_rkvwg", "w0", "u", "ln_x_scale", "ln_x_bias", "ffn_mu_k",
                    "ffn_mu_r"})
    mgr.close()
    out2 = train(RunConfig(**common), log_every=100, device="cpu")
    assert not out2["preempted"] and out2["steps_done"] == 3
    losses = out1["losses"] + out2["losses"]
    assert len(losses) == 6 and np.isfinite(losses).all()
    out2["manager"].close()
