"""The port's training path (optimizer, compression, chunked CE, the train
step, the attention route under autograd) against the JAX package's, on the
CPU.

Both packages compute from the same numpy inputs made from a seed; the JAX
package's ``init`` draws the weights and ``train_state_from_numpy`` carries
them into the port.  Tolerances, stated where they are used:

* ``learning_rate``, ``adamw_update`` and ``compress_grads`` are held bit
  for bit against the JAX functions called op by op (as the source reads;
  under ``jax.jit`` XLA reassociates the schedule's divisions and differs
  from its own op-by-op form by up to ~11 ulps).  Two exceptions, each
  with its reason: the cosine schedule's ``cos`` (XLA's CPU ``cos`` is its
  own approximation, off from PyTorch's, and from the correctly rounded
  value, in the last bit for some arguments; near cos = -1 that ulp is a
  few ulps of the rate) and, where the clip is active, the clip scale (the
  global norm's f32 sums run in another order), within the bounds stated
  in the tests;
* a whole train step is held against JAX's jitted ``make_train_step``
  within a bf16 tolerance: the loss and grad norm to 1e-3 relative, and
  each updated param to ``2 * lr`` plus one bf16 ulp of its value (a first
  Adam step moves an element by about ``lr * sign(g)``, so a gradient of
  the other sign near zero moves it the other way, and the bf16 rounding of
  the result adds an ulp), for at most 2% of the elements.  For the MoE
  and MLA archs (reduced DeepSeek-V3 with its MTP loss, reduced
  Phi-3.5-MoE) the routes are compared first, with JAX's recorded inside
  each jitted program, and where they differ (near ties only) the port
  takes JAX's experts (tests/torch_moe_routes.py); their gradients are then
  also held against ``jax.grad``, every leaf within ``MOE_GRAD_TOL`` = 3e-2
  of its norm (bf16 gradients through up to five layers: the sound readings
  reach 1.3e-2 at reduced DeepSeek-V3's q_norm, 8.8e-3 for Phi-3.5-MoE; on
  their own routes, the flipped layers' routers and expert stacks part from
  JAX's by 6-11%).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.distributed import compression as jax_comp
from repro.models import get_model as jax_get_model
from repro.training import optimizer as jax_opt
from repro.training import train_loop as jax_tl
from repro_torch.configs import ARCHS
from repro_torch.distributed import compression as port_comp
from repro_torch.kernels import flash_attention as port_flash
from repro_torch.models import attention as port_attention
from repro_torch.models import get_model
from repro_torch.models.convert import (
    params_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from repro_torch.training import optimizer as port_opt
from repro_torch.training import train_loop as port_tl
from repro_torch.tree import tree_leaves, tree_paths
from torch_moe_routes import (
    assert_near_ties,
    forced_routes,
    jax_recorded_routes,
    routes_by_layer,
)

B, S = 2, 128          # S a multiple of 128: the flash route's shape
OPT = dict(peak_lr=1e-3, warmup_steps=10, total_steps=50)
MOE_ARCHS = ("deepseek-v3-671b", "phi3.5-moe-42b-a6.6b")
MOE_GRAD_TOL = 3e-2


def bits(a):
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32, 1: np.uint8}[a.dtype.itemsize])


def ulps(a, b):
    """The largest distance in f32 ulps between two f32 arrays."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def t32(a):
    return torch.from_numpy(np.array(a, np.float32))


# ----------------------------------------------------------------- schedules
class TestSchedules:
    @pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
    @pytest.mark.parametrize("warmup,total", [(10, 110), (0, 100), (100, 10_000)])
    def test_learning_rate_matches_jax(self, schedule, warmup, total):
        cfg_kw = dict(peak_lr=1e-3, warmup_steps=warmup, total_steps=total,
                      schedule=schedule)
        steps = np.unique(np.concatenate([np.arange(0, 130), [total - 1, total, total + 7]]))
        want = np.asarray(jax_opt.learning_rate(jax_opt.OptimizerConfig(**cfg_kw),
                                                jnp.asarray(steps, jnp.int32)))
        # a 0-d step each, as adamw_update calls it (on the CPU PyTorch's
        # vectorised pow, unlike its scalar one, differs from XLA's)
        pcfg = port_opt.OptimizerConfig(**cfg_kw)
        got = np.float32([port_opt.learning_rate(pcfg, torch.tensor(int(i), dtype=torch.int32))
                          for i in steps])
        if schedule == "cosine":
            # XLA's CPU cos and PyTorch's differ in the last bit for some
            # arguments (held below on the schedule's own arguments); one ulp
            # of cos (at most 2**-23) scaled by (1 - final_lr_frac) / 2 and
            # peak_lr, plus the two closing products' roundings, bounds the
            # difference (near cos = -1 that is a few ulps of the rate)
            t = np.clip((steps.astype(np.float32) - warmup)
                        / np.float32(max(1, total - warmup)), 0, 1).astype(np.float32)
            arg = np.float32(np.pi) * t
            assert ulps(torch.cos(torch.from_numpy(arg)).numpy(), jnp.cos(arg)) <= 1
            bound = 1e-3 * 0.45 * 2.0**-23 + 2 * np.spacing(np.abs(want))
            assert (np.abs(got - want) <= bound).all()
        else:
            np.testing.assert_array_equal(bits(got), bits(want))


# -------------------------------------------------------------------- AdamW
def adamw_inputs(seed, grad_scale):
    """bf16 params (2-D, a stacked (layers, d) norm scale, 1-D, 3-D) and
    grads, f32 moments after a few steps, step 3."""
    rng = np.random.RandomState(seed)
    shapes = {"w": (16, 32), "stacked_norm": (4, 32), "bias": (32,), "w3": (4, 8, 16)}
    bf = lambda a: a.astype(ml_dtypes.bfloat16)
    params = {k: bf(rng.randn(*s) * 0.02) for k, s in shapes.items()}
    grads = {k: bf(rng.randn(*s) * grad_scale) for k, s in shapes.items()}
    mu = {k: (rng.randn(*s) * 1e-3).astype(np.float32) for k, s in shapes.items()}
    nu = {k: (rng.rand(*s) * 1e-6).astype(np.float32) for k, s in shapes.items()}
    return params, grads, {"mu": mu, "nu": nu, "step": np.int32(3)}


def run_both(cfg_kw, params, grads, opt):
    jp, jopt, jm = jax_opt.adamw_update(
        jax_opt.OptimizerConfig(**cfg_kw), jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, opt))
    state = train_state_from_numpy({"params": params, "opt": opt}, "cpu")
    pgrads = params_from_numpy(grads, "cpu")
    pp, popt, pm = port_opt.adamw_update(port_opt.OptimizerConfig(**cfg_kw), state["params"],
                                         pgrads, state["opt"])
    assert pp is state["params"]  # updated in place
    got = train_state_to_numpy({"params": pp, "opt": popt})
    want = jax.tree.map(np.asarray, {"params": jp, "opt": jopt})
    return got, want, pm, jm


class TestAdamW:
    def test_unclipped_update_is_bit_identical(self):
        # grad norm ~1.6 < grad_clip 10: the clip scale is exactly 1
        got, want, pm, jm = run_both(dict(OPT, grad_clip=10.0), *adamw_inputs(0, 0.02))
        assert float(jm["grad_norm"]) < 10.0
        for (k, g), (_, w) in zip(tree_paths(got), tree_paths(want)):
            np.testing.assert_array_equal(bits(g), bits(w), err_msg=k)
        assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == 4
        np.testing.assert_array_equal(bits(pm["lr"].numpy()), bits(np.asarray(jm["lr"])))
        # the global norm's sums run in another order
        np.testing.assert_allclose(pm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-6)

    def test_clipped_update_within_the_norms_difference(self):
        """Grad norm ~7 > grad_clip 1: the clip scale comes from the global
        norm, whose f32 sums PyTorch and XLA order differently (1e-6
        relative, a few ulps).  The scaled gradient carries that difference
        into μ once and into ν twice, so each stays within 2e-6 / 4e-6 of the
        magnitudes of its two terms; the bf16 params within one bf16 ulp."""
        params, grads, opt = adamw_inputs(1, 0.2)
        got, want, pm, jm = run_both(dict(OPT, grad_clip=1.0), params, grads, opt)
        assert float(jm["grad_norm"]) > 1.0
        np.testing.assert_allclose(pm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-6)
        gs = {k: np.abs(g.astype(np.float32)) / float(jm["grad_norm"]) for k, g in grads.items()}
        for k in gs:
            mu_terms = 0.9 * np.abs(opt["mu"][k]) + 0.1 * gs[k]
            nu_terms = 0.95 * opt["nu"][k] + 0.05 * gs[k] ** 2
            assert (np.abs(got["opt"]["mu"][k] - want["opt"]["mu"][k]) <= 2e-6 * mu_terms).all()
            assert (np.abs(got["opt"]["nu"][k] - want["opt"]["nu"][k]) <= 4e-6 * nu_terms).all()
            gp = bits(got["params"][k]).astype(np.int32)
            wp = bits(want["params"][k]).astype(np.int32)
            assert np.abs(gp - wp).max() <= 1, k

    def test_decay_reaches_stacked_norm_scales(self):
        """JAX decays every leaf of two or more dims, so a stacked (layers, d)
        norm scale is decayed while a 1-D one is not: with zero grads only
        the decay moves a param."""
        params, grads, opt = adamw_inputs(2, 0.0)
        grads = {k: np.zeros_like(v) for k, v in grads.items()}
        opt = {"mu": {k: np.zeros_like(v) for k, v in opt["mu"].items()},
               "nu": {k: np.zeros_like(v) for k, v in opt["nu"].items()},
               "step": np.int32(20)}
        got, want, _, _ = run_both(dict(OPT, peak_lr=0.1, weight_decay=0.5), params, grads,
                                   opt)
        for k in params:
            np.testing.assert_array_equal(bits(got["params"][k]), bits(want["params"][k]))
        moved = lambda k: not np.array_equal(bits(got["params"][k]), bits(params[k]))
        assert moved("stacked_norm") and moved("w") and moved("w3")
        assert not moved("bias")


# -------------------------------------------------------------- compression
class TestCompression:
    @pytest.mark.parametrize("n", [1, 255, 256, 257, 1000])
    def test_compress_grads_bit_for_bit(self, n):
        rng = np.random.RandomState(n)
        g = (rng.randn(n) * 0.1).astype(np.float32)
        # exact halves: a block whose max is 127 has scale 1, so x / scale
        # is x itself and round() meets .5 ties (half to even in both)
        g[: min(n, 6)] = np.float32([127.0, 2.5, -3.5, 0.5, -1.5, 126.5])[: min(n, 6)]
        e = (rng.randn(n) * 0.01).astype(np.float32)
        grads = {"a": g.reshape(-1, 1) if n % 2 else g, "b": [g[::-1].copy()]}
        errs = {"a": e.reshape(grads["a"].shape), "b": [e.copy()]}
        jc, je = jax_comp.compress_grads(jax.tree.map(jnp.asarray, grads),
                                         jax.tree.map(jnp.asarray, errs))
        pc, pe = port_comp.compress_grads(
            {"a": t32(grads["a"]), "b": [t32(grads["b"][0])]},
            {"a": t32(errs["a"]), "b": [t32(errs["b"][0])]})
        for (k, w), (_, gt) in zip(tree_paths(jax.tree.map(np.asarray, (jc, je))),
                                   tree_paths((pc, pe))):
            assert gt.shape == w.shape, k
            np.testing.assert_array_equal(bits(gt.numpy()), bits(w), err_msg=k)

    def test_quantize_zeros_and_bf16(self):
        x = np.zeros(300, np.float32)
        np.testing.assert_array_equal(port_comp.quant_dequant(t32(x)).numpy(), x)
        xb = (np.random.RandomState(4).randn(3, 100)).astype(ml_dtypes.bfloat16)
        want = np.asarray(jax_comp.quant_dequant(jnp.asarray(xb)))
        got = port_comp.quant_dequant(
            torch.from_numpy(xb.view(np.uint16)).view(torch.bfloat16)).numpy()
        np.testing.assert_array_equal(bits(got), bits(want))

    def test_compressed_psum_waits_for_the_mesh(self):
        """Outside a ``logical_sharding`` mesh there is no axis to sum over
        (JAX raises its unbound-axis error); the all-reduce itself is held
        against JAX's in tests/test_torch_mesh_ranks.py."""
        with pytest.raises(ValueError, match="logical_sharding"):
            port_comp.compressed_psum(torch.zeros(4), "data")


# --------------------------------------------------------------- chunked CE
class TestChunkedCE:
    @pytest.mark.parametrize("S_", [70, 600])
    def test_matches_jax_and_unchunked(self, S_):
        """600 tokens: a whole 512-token chunk and a short one (JAX pads and
        masks it); the values to 1e-5 relative, the hidden states' gradient
        through the recomputed chunks to 1e-4."""
        rng = np.random.RandomState(S_)
        Bc, D, V = 2, 16, 50
        hidden = rng.randn(Bc, S_, D).astype(np.float32)
        head = rng.randn(D, V).astype(np.float32)
        targets = rng.randint(0, V, (Bc, S_)).astype(np.int32)
        jhead = lambda p, h: jnp.einsum("bsd,dv->bsv", h, p)

        def jloss(h):
            return jax_tl.chunked_cross_entropy(jhead, jnp.asarray(head), h,
                                                jnp.asarray(targets), 1e-4)

        want, want_grad = jax.value_and_grad(jloss)(jnp.asarray(hidden))
        h = torch.from_numpy(hidden).requires_grad_(True)
        got = port_tl.chunked_cross_entropy(lambda p, x: x @ p, torch.from_numpy(head), h,
                                            torch.from_numpy(targets), 1e-4)
        (got_grad,) = torch.autograd.grad(got, h)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
        np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad), rtol=1e-4,
                                   atol=1e-8)
        full = port_tl.cross_entropy(torch.from_numpy(hidden) @ torch.from_numpy(head),
                                     torch.from_numpy(targets), 1e-4)
        np.testing.assert_allclose(got.item(), full.item(), rtol=1e-5)


# --------------------------------------------------------------- train step
def jax_state0(arch):
    """The JAX package's bundle and fresh train state (params from its init)."""
    bundle = jax_get_model(JAX_ARCHS[arch].reduced())
    params = bundle.init(jax.random.PRNGKey(0))
    return bundle, params, jax_opt.init_opt_state(params)


def n_moe_layers(arch) -> int:
    cfg = ARCHS[arch].reduced()
    return sum(cfg.layer_uses_moe(i) for i in range(cfg.n_layers)) if cfg.n_experts else 0


def jax_run(arch, tokens, *, grads=False, **tkw):
    """The JAX package's state, one jitted train step of it, and (if asked)
    its gradients, all as numpy trees; for an MoE arch, the routes each
    jitted program took, one (B, S, K) array an MoE layer."""
    bundle, params, opt = jax_state0(arch)
    state0 = jax.tree.map(np.asarray, {"params": params, "opt": opt})
    tcfg = jax_tl.TrainConfig(optimizer=jax_opt.OptimizerConfig(**OPT), **tkw)
    batch = {"tokens": jnp.asarray(tokens)}
    n_moe = n_moe_layers(arch)
    with jax_recorded_routes() as calls:
        new, metrics = jax.jit(jax_tl.make_train_step(bundle, tcfg))(
            {"params": params, "opt": opt, "error_fb": None}, batch)
        jax.block_until_ready(new)
    out = {"state0": state0, "state1": jax.tree.map(np.asarray, {"params": new["params"],
                                                               "opt": new["opt"]}),
           "metrics": {k: float(v) for k, v in metrics.items()},
           "step_routes": routes_by_layer(calls, n_moe) if n_moe else None}
    if grads:
        with jax_recorded_routes() as calls:
            g = jax.jit(jax.grad(jax_tl.make_loss_fn(bundle, tcfg)))(params, batch)
            jax.block_until_ready(g)
        out["grads"] = jax.tree.map(lambda a: np.asarray(a, np.float32), g)
        out["grad_routes"] = routes_by_layer(calls, n_moe) if n_moe else None
    return out


def port_step(arch, state0, tokens, routes=None, **tkw):
    """One port train step from ``state0``; with ``routes`` (JAX's), the
    MoE layers take JAX's experts where theirs differ, and the flipped
    positions are checked to be near ties."""
    bundle = get_model(ARCHS[arch].reduced())
    state = train_state_from_numpy(state0, "cpu")
    tcfg = port_tl.TrainConfig(optimizer=port_opt.OptimizerConfig(**OPT), **tkw)
    step = port_tl.make_train_step(bundle, tcfg)
    with forced_routes(routes or []) as flips:
        new, metrics = step(state, {"tokens": torch.from_numpy(tokens)})
    if routes:
        assert_near_ties(flips, len(routes) * tokens.size)
    return bundle, tcfg, train_state_to_numpy(new), {k: v.item() for k, v in metrics.items()}


def port_grads(arch, state0, tokens, routes):
    """The port's gradients (f32 numpy, by path) of its loss at ``state0``,
    on JAX's routes where they differ at a near tie; and the flips."""
    bundle = get_model(ARCHS[arch].reduced())
    params = train_state_from_numpy(state0, "cpu")["params"]
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss_fn = port_tl.make_loss_fn(bundle, port_tl.TrainConfig(
        optimizer=port_opt.OptimizerConfig(**OPT)))
    with forced_routes(routes) as flips:
        grads = torch.autograd.grad(loss_fn(params, {"tokens": torch.from_numpy(tokens)}),
                                    leaves)
    assert_near_ties(flips, len(routes) * tokens.size)
    return {k: g.float().numpy() for (k, _), g in zip(tree_paths(params), grads)}, flips


SMALL_LEAF = 1024  # elements: the norm scales


def hold_step(got, want, got_m, want_m, *, moe=False, norm_rtol=1e-3, share=0.02):
    """A train step's loss, grad norm, lr and every updated param against
    JAX's, with the bf16 tolerance of the module docstring.  With ``moe``
    (named for the MoE and MLA archs; the recurrent archs, with their f32
    vectors, and the enc-dec arch, with its norm scales, take it too:
    tests/test_torch_train_recurrent.py, tests/test_torch_train_encdec.py)
    the share of elements that may differ counts an element only when it is
    off by more than a hundredth of a step (lr / 100: their f32 routers keep
    the f32 rounding of an update, ~1e-9 here, which a bf16 leaf rounds
    away), and
    the leaves under ``SMALL_LEAF`` elements are counted together (MLA's
    q_norm scales: of their 64-192 gradients, each a sum over every token,
    the few nearest zero move their update by up to a tenth of a step, 7 of
    192 at reduced DeepSeek-V3).  ``norm_rtol`` (the grad norm's relative
    tolerance) and ``share`` (of the elements that may differ) are the
    module docstring's 1e-3 and 2% unless a caller states its own."""
    np.testing.assert_allclose(got_m["loss"], want_m["loss"], rtol=1e-3)
    np.testing.assert_allclose(got_m["grad_norm"], want_m["grad_norm"], rtol=norm_rtol)
    assert np.float32(got_m["lr"]) == np.float32(want_m["lr"])
    lr = want_m["lr"]
    floor = lr / 100 if moe else 0.0
    small = []
    for (k, g), (k2, w) in zip(tree_paths(got["params"]), tree_paths(want["params"])):
        assert k == k2 and g.shape == w.shape and g.dtype == w.dtype
        g32, w32 = g.astype(np.float32), w.astype(np.float32)
        # one bf16 ulp of the larger magnitude: 2**(exponent - 7)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.maximum(abs(g32), abs(w32)), 1e-30))) - 7)
        diff = np.abs(g32 - w32)
        assert (diff <= 2 * lr + ulp).all(), (k, diff.max())
        if moe and diff.size < SMALL_LEAF:
            small.append(diff.reshape(-1))
            continue
        assert np.mean(diff > floor) <= share, (k, np.mean(diff > floor))
    if small:
        assert np.mean(np.concatenate(small) > floor) <= share, (
            "the small leaves", np.mean(np.concatenate(small) > floor))
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == 1


@pytest.fixture
def flash_forbidden(monkeypatch):
    """The flash kernel made to raise wherever attention calls it: training
    must take the chunked softmax."""
    def refuse(*a, **k):
        raise AssertionError("the train step reached the flash kernel")

    monkeypatch.setattr(port_attention, "flash_attention", refuse)


class TestTrainStep:
    @pytest.mark.parametrize("arch", ["minicpm-2b", "minitron-4b", *MOE_ARCHS])
    def test_one_step_matches_jax(self, arch, flash_forbidden):
        """minicpm-2b (MHA, tied embeddings), minitron-4b (GQA), DeepSeek-V3
        (MLA, a dense and three MoE layers with a shared expert, the MTP
        loss) and Phi-3.5-MoE (GQA, four MoE layers) reduced, S = 128, from
        weights carried out of the JAX package.  For the MoE archs the
        gradients too, every leaf's: the MTP head's, the f32 routers' and
        every expert stack's among them."""
        tokens = np.random.RandomState(7).randint(0, 512, (B, S)).astype(np.int32)
        moe = arch in MOE_ARCHS
        ref = jax_run(arch, tokens, grads=moe)
        _, _, got, got_m = port_step(arch, ref["state0"], tokens, routes=ref["step_routes"])
        hold_step(got, ref["state1"], got_m, ref["metrics"], moe=moe)
        if not moe:
            return
        grads, flips = port_grads(arch, ref["state0"], tokens, ref["grad_routes"])
        want = dict(tree_paths(ref["grads"]))
        assert set(want) == set(grads)
        ratios = {k: float(np.linalg.norm(g - want[k]) / np.linalg.norm(want[k]))
                  for k, g in grads.items()}
        bad = {k: r for k, r in ratios.items() if not r < MOE_GRAD_TOL}
        assert not bad, (bad, flips)
        assert all(np.abs(g).max() > 0 for g in grads.values())
        names = {k.split("/")[0] for k in grads} | {k.rsplit("/", 1)[-1] for k in grads}
        assert {"router", "w_gate", "w_up", "w_down"} <= names
        assert ("mtp" in names) == (arch == "deepseek-v3-671b")

    def test_grad_accum_matches_full_batch(self):
        """As tests/test_training.py holds the JAX package: 2 microbatches of
        2 against the batch of 4."""
        tokens = np.random.RandomState(8).randint(0, 512, (4, 32)).astype(np.int32)
        _, params, opt = jax_state0("minitron-4b")
        state0 = jax.tree.map(np.asarray, {"params": params, "opt": opt})
        _, _, p1, m1 = port_step("minitron-4b", state0, tokens)
        _, _, p2, m2 = port_step("minitron-4b", state0, tokens, grad_accum=2)
        assert m1["loss"] == pytest.approx(m2["loss"], rel=2e-2)
        for a, b in zip(tree_leaves(p1["params"]), tree_leaves(p2["params"])):
            np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32),
                                       rtol=5e-2, atol=5e-3)

    def test_accum_and_compression_match_jax(self):
        tokens = np.random.RandomState(9).randint(0, 512, (4, 32)).astype(np.int32)
        ref = jax_run("minitron-4b", tokens, grad_accum=2, compress_grads=True)
        _, _, got, got_m = port_step("minitron-4b", ref["state0"], tokens, grad_accum=2,
                                     compress_grads=True)
        hold_step(got, ref["state1"], got_m, ref["metrics"])


class TestTrainingRoute:
    def test_attention_weights_get_gradients(self, flash_forbidden):
        """The repair: at S = 128, a multiple of 128, the port took the flash
        kernel in every mode, and on the card its output carried no gradient.
        Under autograd the route is now the chunked softmax (the kernel here
        raises if reached); every attention weight gets a non-zero gradient,
        within 2e-2 (relative to the leaf's norm; bf16 gradients) of JAX's."""
        arch = "minicpm-2b"
        tokens = np.random.RandomState(10).randint(0, 512, (B, S)).astype(np.int32)
        ref = jax_run(arch, tokens, grads=True)
        bundle = get_model(ARCHS[arch].reduced())
        state = train_state_from_numpy(ref["state0"], "cpu")
        leaves = [p.requires_grad_(True) for p in tree_leaves(state["params"])]
        tcfg = port_tl.TrainConfig(optimizer=port_opt.OptimizerConfig(**OPT))
        loss = port_tl.make_loss_fn(bundle, tcfg)(state["params"],
                                                  {"tokens": torch.from_numpy(tokens)})
        grads = torch.autograd.grad(loss, leaves)
        paths = [k for k, _ in tree_paths(state["params"])]
        want = dict(tree_paths(ref["grads"]))
        seen = 0
        for k, g in zip(paths, grads):
            if k.rsplit("/", 1)[-1] in ("wq", "wk", "wv", "wo"):
                g = g.float().numpy()
                assert np.abs(g).max() > 0, k
                rel = np.linalg.norm(g - want[k]) / np.linalg.norm(want[k])
                assert rel < 2e-2, (k, rel)
                seen += 1
        assert seen == 4

    def test_prefill_keeps_the_flash_route(self, monkeypatch):
        calls = []

        def fake(q, k, v, **kw):
            calls.append(q.shape)
            return port_flash.flash_attention_ref(q, k, v, causal=kw["causal"])

        monkeypatch.setattr(port_attention, "flash_attention", fake)
        q = torch.randn(1, 128, 4, 32, dtype=torch.bfloat16)
        with torch.no_grad():
            port_attention._full_attention(q, q, q, causal=True)
        assert len(calls) == 1
        port_attention._full_attention(q, q, q.requires_grad_(True), causal=True)
        assert len(calls) == 1  # v requires grad: the chunked softmax

    def test_cuda_path_refuses_grad_before_any_launch(self, monkeypatch):
        """On the card the kernel's output would carry no gradient: the
        wrapper's CUDA path raises on an input that requires grad under grad
        mode, before it launches (checked here with the CUDA path forced on
        CPU tensors and a launch that records)."""
        launched = []

        def launch(*a, **k):
            launched.append(a[0])
            raise RuntimeError("launched")

        monkeypatch.setattr(port_flash, "is_cpu", lambda *t: False)
        monkeypatch.setattr(port_flash, "launch", launch)
        q = torch.randn(1, 128, 4, 32, dtype=torch.bfloat16)
        k = torch.randn(1, 128, 4, 32, dtype=torch.bfloat16, requires_grad=True)
        with pytest.raises(ValueError, match="forward-only"):
            port_flash.flash_attention(q, k, k)
        assert launched == [] and port_flash.flash_attention.launches == 0
        with torch.no_grad(), pytest.raises(RuntimeError, match="launched"):
            port_flash.flash_attention(q, k, k)  # no grad mode: the guard lets it by
        assert launched == ["attention_flash_fwd"]
