"""The port's dense LM (layers, GQA attention, the whole model) against the
JAX package's, on the CPU.

Both packages compute from the same numpy inputs and the same weights: the
JAX package's ``init`` draws them and ``params_from_numpy`` carries them
into the port.  The five dense configs run at their ``reduced()`` size
(minicpm-2b: MHA, tied embeddings; minitron-4b; starcoder2-7b: GELU;
qwen3-32b and chameleon-34b: qk-norm).  The port's attention takes the flash path wherever
the JAX opt-in path would (here through its plain version); the JAX side
runs with ``REPRO_FLASH_ATTN=1`` (its Pallas kernel in interpret mode) and
without it (its chunked softmax).  Tolerances: 2e-2 for prefill and
teacher-forcing logits and 5e-2 for decode logits, as in
tests/test_arch_smoke.py; 1e-2 relative (about one bf16 rounding step of
2**-8, with f32 math ordered differently) for single layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import attention as jax_attention
from repro.models import get_model as jax_get_model
from repro.models import layers as jax_layers
from repro.models import transformer as jax_tf
from repro.training import train_loop as jax_tl
from repro_torch.configs import ARCHS
from repro_torch.models import count_params, get_model
from repro_torch.models import attention as port_attention
from repro_torch.models import encdec as port_encdec
from repro_torch.models import layers as port_layers
from repro_torch.models import transformer as port_tf
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.launch.train import RunConfig, train
from repro_torch.training.train_loop import TrainConfig, make_loss_fn

DENSE = ["minicpm-2b", "minitron-4b", "starcoder2-7b", "qwen3-32b", "chameleon-34b"]
B, S = 2, 128          # S a multiple of 128: the prefill takes the flash path
LAYER_TOL = dict(rtol=1e-2, atol=1e-5)


def bf16(rng, *shape, scale=1.0):
    """The same bf16 values as a JAX array and as a CPU tensor."""
    a = np.asarray(jnp.asarray(rng.randn(*shape) * scale, jnp.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)


def f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(f32(got), f32(want), **tol)


# -------------------------------------------------------------------- layers
class TestLayers:
    def test_rms_norm(self):
        rng = np.random.RandomState(0)
        (xj, xt), (sj, st) = bf16(rng, 2, 8, 64), bf16(rng, 64, scale=0.1)
        close(port_layers.rms_norm(xt, st, 1e-6), jax_layers.rms_norm(xj, sj, 1e-6), **LAYER_TOL)

    def test_rope(self):
        rng = np.random.RandomState(1)
        pos = np.arange(128)
        cj, sj = jax_layers.rope_table(jnp.asarray(pos), 32, 1e4)
        ct, st = port_layers.rope_table(torch.from_numpy(pos), 32, 1e4)
        close(ct, cj, atol=1e-5)
        close(st, sj, atol=1e-5)
        xj, xt = bf16(rng, 2, 128, 4, 32)
        close(port_layers.apply_rope(xt, ct, st), jax_layers.apply_rope(xj, cj, sj), **LAYER_TOL)
        # per-batch tables (B, S, hd/2)
        cj3, sj3 = jax_layers.rope_table(jnp.asarray(np.stack([pos, pos + 7])), 32, 1e6)
        ct3, st3 = port_layers.rope_table(torch.from_numpy(np.stack([pos, pos + 7])), 32, 1e6)
        close(port_layers.apply_rope(xt, ct3, st3), jax_layers.apply_rope(xj, cj3, sj3),
              **LAYER_TOL)

    @pytest.mark.parametrize("kind", ["swiglu", "gelu"])
    def test_mlp(self, kind):
        rng = np.random.RandomState(2)
        xj, xt = bf16(rng, 2, 16, 64)
        names = ("w_gate", "w_up", "w_down") if kind == "swiglu" else ("w_in", "w_out")
        shapes = {"w_gate": (64, 96), "w_up": (64, 96), "w_down": (96, 64),
                  "w_in": (64, 96), "w_out": (96, 64)}
        pj, pt = {}, {}
        for n in names:
            pj[n], pt[n] = bf16(rng, *shapes[n], scale=0.1)
        fj = jax_layers.mlp_swiglu if kind == "swiglu" else jax_layers.mlp_gelu
        ft = port_layers.mlp_swiglu if kind == "swiglu" else port_layers.mlp_gelu
        close(ft(xt, pt), fj(xj, pj), rtol=2e-2, atol=2e-2)

    @pytest.mark.parametrize("case", [
        # Sq, Sk, KV, causal, chunk, kv_len, q_offset
        (64, 64, 2, True, 32, None, 0),      # prefill, two chunks
        (48, 80, 1, True, 32, None, 32),     # chunked prefill: an offset, a ragged last chunk
        (64, 64, 4, False, 64, 50, 0),       # non-causal over a ragged cache
        (1, 96, 2, False, 1024, 37, 0),      # decode: one softmax over the cache
        (1, 96, 2, True, 1024, None, 40),    # decode, causal at an offset
    ])
    def test_chunked_attention(self, case):
        Sq, Sk, KV, causal, chunk, kv_len, q_offset = case
        rng = np.random.RandomState(3)
        (qj, qt), (kj, kt), (vj, vt) = (bf16(rng, 2, Sq, 4, 32), bf16(rng, 2, Sk, KV, 32),
                                        bf16(rng, 2, Sk, KV, 32))
        want = jax_layers.chunked_attention(qj, kj, vj, causal=causal, chunk=chunk,
                                            kv_len=kv_len, q_offset=q_offset)
        got = port_layers.chunked_attention(qt, kt, vt, causal=causal, chunk=chunk,
                                            kv_len=kv_len, q_offset=q_offset)
        assert got.dtype == torch.bfloat16
        close(got, want, rtol=2e-2, atol=2e-2)


# ----------------------------------------------------------------- GQA block
@pytest.fixture(scope="module")
def qwen_layer():
    """One attention layer of reduced qwen3-32b (qk-norm), both packages."""
    cfg_j = JAX_ARCHS["qwen3-32b"].reduced()
    p = jax.tree.map(np.asarray, jax_tf.block_init(cfg_j, "attn", False, jax.random.PRNGKey(3)))
    return cfg_j, ARCHS["qwen3-32b"].reduced(), p


@pytest.mark.parametrize("flash", [True, False], ids=["jax-flash", "jax-chunked"])
def test_gqa_prefill_then_decode(qwen_layer, monkeypatch, flash):
    if flash:
        monkeypatch.setenv("REPRO_FLASH_ATTN", "1")
    else:
        monkeypatch.delenv("REPRO_FLASH_ATTN", raising=False)
    cfg_j, cfg_t, p_np = qwen_layer
    pj = jax.tree.map(jnp.asarray, p_np)
    pt = params_from_numpy(p_np, device="cpu")
    rng = np.random.RandomState(4)
    xj, xt = bf16(rng, B, S, cfg_t.d_model)
    cache_j = jax_attention.gqa_init_cache(cfg_j, B, S + 4)
    cache_t = port_attention.gqa_init_cache(cfg_t, B, S + 4, device="cpu")
    # jitted (one compile, not one per op), traced under this test's setting
    out_j, cache_j = jax.jit(lambda p, x, c: jax_attention.gqa_prefill(cfg_j, p, x, c))(
        pj, xj, cache_j)
    out_t, cache_t2 = port_attention.gqa_prefill(cfg_t, pt, xt, cache_t)
    assert cache_t2 is cache_t  # written in place
    close(out_t, out_j, rtol=2e-2, atol=2e-2)
    for name in ("k", "v"):
        close(cache_t[name], cache_j[name], rtol=2e-2, atol=2e-2)
    tj, tt = bf16(rng, B, 1, cfg_t.d_model)
    dec_j, cache_j = jax.jit(lambda p, x, c: jax_attention.gqa_decode(cfg_j, p, x, c, S))(
        pj, tj, cache_j)
    dec_t, _ = port_attention.gqa_decode(cfg_t, pt, tt, cache_t, S)
    close(dec_t, dec_j, rtol=5e-2, atol=5e-2)
    for name in ("k", "v"):
        close(cache_t[name], cache_j[name], rtol=2e-2, atol=2e-2)
    fwd_j = jax.jit(lambda p, x: jax_attention.gqa_forward(cfg_j, p, x))(pj, xj)
    close(port_attention.gqa_forward(cfg_t, pt, xt), fwd_j, rtol=2e-2, atol=2e-2)


def test_unported_attention_raises(qwen_layer):
    """The attention forms that once raised run: the sliding window
    (tests/test_torch_hybrid.py holds it against the JAX package) and
    cross-attention (the enc-dec family's; tests/test_torch_encdec.py),
    held here against the JAX package's on a layer with qk-norm, which the
    cross-attention's query skips as its rotary phase."""
    cfg_j, cfg_t, p_np = qwen_layer
    pt = params_from_numpy(p_np, device="cpu")
    x = torch.zeros((1, 8, cfg_t.d_model), dtype=torch.bfloat16)
    out = port_attention.gqa_forward(cfg_t, pt, x, window=4)
    assert tuple(out.shape) == (1, 8, cfg_t.d_model) and bool(torch.isfinite(out.float()).all())
    rng = np.random.RandomState(8)
    xj, xt = bf16(rng, B, 16, cfg_t.d_model)
    (kj, kt), (vj, vt) = (bf16(rng, B, 24, cfg_t.n_kv_heads, cfg_t.resolved_head_dim)
                          for _ in range(2))
    want = jax.jit(lambda p, x, kv: jax_attention.gqa_forward(cfg_j, p, x, cross_kv=kv))(
        jax.tree.map(jnp.asarray, p_np), xj, (kj, vj))
    got = port_attention.gqa_forward(cfg_t, pt, xt, cross_kv=(kt, vt))
    assert tuple(got.shape) == (B, 16, cfg_t.d_model)
    # the layer's output is small (wo's std 0.02 / sqrt(layers)): atol a
    # share of its largest value, as tests/test_torch_encdec.py holds layers
    want = np.asarray(want, np.float32)
    close(got, want, rtol=1e-2, atol=1e-2 * float(np.abs(want).max()))


# ---------------------------------------------------------------- the model
@pytest.fixture(scope="module", params=DENSE)
def arch(request):
    """(JAX config, port config, JAX bundle, JAX params as numpy, port params)."""
    cfg_j = JAX_ARCHS[request.param].reduced()
    model = jax_get_model(cfg_j)
    p_np = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    cfg_t = ARCHS[request.param].reduced()
    return cfg_j, cfg_t, model, p_np, params_from_numpy(p_np, device="cpu")


@pytest.mark.parametrize("flash", [True, False], ids=["jax-flash", "jax-chunked"])
def test_model_matches_jax(arch, monkeypatch, flash):
    """forward_train, prefill and one decode step, same weights and tokens."""
    if flash:
        monkeypatch.setenv("REPRO_FLASH_ATTN", "1")
    else:
        monkeypatch.delenv("REPRO_FLASH_ATTN", raising=False)
    cfg_j, cfg_t, model, p_np, pt = arch
    port = get_model(cfg_t)
    pj = jax.tree.map(jnp.asarray, p_np)
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, cfg_t.vocab, (B, S)).astype(np.int32)
    nxt = rng.randint(0, cfg_t.vocab, (B, 1)).astype(np.int32)
    tok_t, nxt_t = torch.from_numpy(tokens).long(), torch.from_numpy(nxt).long()

    # fresh jit wrappers: each traces under this test's REPRO_FLASH_ATTN
    logits_j, _ = jax.jit(lambda p, b: model.train_logits(p, b))(pj, {"tokens": tokens})
    logits_t, _ = port.train_logits(pt, {"tokens": tok_t})
    assert tuple(logits_t.shape) == (B, S, cfg_t.padded_vocab)
    close(logits_t, logits_j, rtol=2e-2, atol=2e-2)

    pre_j, cache_j = jax.jit(lambda p, b, c: model.prefill(p, b, c))(
        pj, {"tokens": tokens}, model.init_cache(B, S + 8))
    pre_t, cache_t = port.prefill(pt, {"tokens": tok_t}, port.init_cache(B, S + 8, device="cpu"))
    close(pre_t, pre_j, rtol=2e-2, atol=2e-2)

    dec_j, _ = jax.jit(lambda p, t, c: model.decode_step(p, t, c, S))(pj, nxt, cache_j)
    dec_t, _ = port.decode_step(pt, nxt_t, cache_t, S)
    close(dec_t, dec_j, rtol=5e-2, atol=5e-2)


def test_prefill_then_decode_matches_forward(arch):
    """The port's cache path against its own teacher forcing (as
    tests/test_arch_smoke.py holds the JAX package's)."""
    _, cfg_t, _, _, pt = arch
    port = get_model(cfg_t)
    rng = np.random.RandomState(6)
    tokens = torch.from_numpy(rng.randint(0, cfg_t.vocab, (B, S + 1))).long()
    full, _ = port.train_logits(pt, {"tokens": tokens})
    pre, cache = port.prefill(pt, {"tokens": tokens[:, :S]}, port.init_cache(B, S + 8, device="cpu"))
    close(pre[:, -1], full[:, S - 1], rtol=2e-2, atol=2e-2)
    dec, _ = port.decode_step(pt, tokens[:, S:], cache, S)
    close(dec[:, -1], full[:, S], rtol=5e-2, atol=5e-2)


def test_params_round_trip_bit_for_bit(arch):
    _, _, _, p_np, pt = arch
    back = params_to_numpy(pt)
    want, want_def = jax.tree.flatten(p_np)
    got, got_def = jax.tree.flatten(back)
    assert got_def == want_def
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def _non_norm_count(tree) -> int:
    return sum(a.size for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]
               if "norm" not in jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", DENSE + ["phi3.5-moe-42b-a6.6b", "deepseek-v3-671b",
                                  "rwkv6-3b", "recurrentgemma-9b"])
def test_init_params_tree_matches_jax(name):
    """The port's init draws the JAX tree's shapes and dtypes (the MoE
    routers and the recurrent blocks' vectors f32), on the caller's device
    from the caller's generator, with the stds of _nrm (the RG-LRU's Λ
    uniform on (0, 1), RWKV's ln_x scale ones).  Its parameters, norm scales
    aside, number as many as the JAX tree's, and as ``count_params`` counts
    but where the MTP block is MLA, which it counts as GQA
    (tests/test_torch_mla.py), and for RWKV-6, whose twelve D-vectors a
    layer it leaves out (ROADMAP Queue 3)."""
    cfg_t = ARCHS[name].reduced()
    p_np = jax.tree.map(np.asarray, jax_get_model(JAX_ARCHS[name].reduced()).init(
        jax.random.PRNGKey(0)))
    gen = torch.Generator().manual_seed(0)
    pt = get_model(cfg_t).init(gen, device="cpu")
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), p_np)
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
                       params_to_numpy(pt))
    assert got == want
    assert abs(float(pt["embed"].float().std()) - 0.02) < 2e-3
    total = _non_norm_count(params_to_numpy(pt))
    assert total == _non_norm_count(p_np)
    if cfg_t.layer_pattern == ("rwkv",):
        assert total - count_params(cfg_t) == 12 * cfg_t.d_model * cfg_t.n_layers
    elif name == "recurrentgemma-9b":
        lam = pt["segments"][0][0]["lambda"]
        assert float(lam.min()) >= 0.0 and float(lam.max()) < 1.0 and lam.dtype == torch.float32
        assert total == count_params(cfg_t)
    elif not (cfg_t.mtp and cfg_t.blocks()[-1] == "mla"):
        assert total == count_params(cfg_t)


@pytest.mark.parametrize("name", ["phi3.5-moe-42b-a6.6b", "deepseek-v3-671b", "rwkv6-3b",
                                  "recurrentgemma-9b", "seamless-m4t-medium"])
def test_other_families_raise(name, tmp_path, monkeypatch):
    """What the port does not run raises, naming its reason: the
    enc-dec family in ``launch.train.train``, which refuses it before it
    draws a parameter, as the JAX package's driver cannot train it either
    (its pipeline makes tokens only; the family trains through
    ``make_train_step``, tests/test_torch_train_encdec.py).  The recurrent
    families, which the driver once refused, serve and train through it
    (tests/test_torch_train_recurrent.py).  DeepSeek's train loss, which
    once raised rather than drop the MTP term, now includes it and equals
    JAX's on the same weights and tokens.  Phi-3.5-MoE's expert-parallel
    form (``moe_impl="ep"``), which once raised, runs: with no mesh it is
    the dispatch, bit for bit (the JAX module's rule; on a mesh,
    tests/test_torch_mesh_ranks.py)."""
    if name not in ARCHS:
        pytest.fail(f"{name} is not an arch: {sorted(ARCHS)}")
    cfg = ARCHS[name]
    if name == "phi3.5-moe-42b-a6.6b":
        small = cfg.reduced()
        params = get_model(small).init(torch.Generator().manual_seed(0), device="cpu")
        tokens = torch.from_numpy(np.random.RandomState(6).randint(0, small.vocab, (2, 16)))
        with torch.no_grad():
            want = get_model(small).train_logits(params, {"tokens": tokens})[0]
            got = get_model(dataclasses.replace(small, moe_impl="ep")).train_logits(
                params, {"tokens": tokens})[0]
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
        return
    if name == "deepseek-v3-671b":
        model = jax_get_model(JAX_ARCHS[name].reduced())
        pj = model.init(jax.random.PRNGKey(0))
        tokens = np.random.RandomState(6).randint(0, 512, (1, 16)).astype(np.int32)
        want = float(jax.jit(jax_tl.make_loss_fn(model, jax_tl.TrainConfig()))(
            pj, {"tokens": jnp.asarray(tokens)}))
        bundle = get_model(cfg.reduced())
        params = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
        batch = {"tokens": torch.from_numpy(tokens).long()}
        assert "mtp_hidden" in bundle.train_hidden(params, batch)[1]
        with torch.no_grad():
            got = make_loss_fn(bundle, TrainConfig())(params, batch).item()
            main = make_loss_fn(bundle, TrainConfig(mtp_weight=0.0))(params, batch).item()
        np.testing.assert_allclose(got, want, rtol=1e-3)
        assert got - main > 0.3  # 0.3 x the MTP head's CE (~ln 512) is in the loss
        return
    if name in ("rwkv6-3b", "recurrentgemma-9b"):
        bundle = get_model(cfg.reduced())
        params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
        tokens = torch.zeros((1, 8), dtype=torch.int64)
        logits, _ = bundle.prefill(params, {"tokens": tokens},
                                   bundle.init_cache(1, 9, device="cpu"))
        assert tuple(logits.shape) == (1, 1, cfg.reduced().padded_vocab)
        out = train(RunConfig(arch=name, steps=1, seq_len=16, global_batch=2, save_every=0,
                              ckpt_dir=str(tmp_path)), device="cpu")
        assert out["steps_done"] == 1 and np.isfinite(out["losses"]).all()
        out["manager"].close()
        return
    # the enc-dec family serves (tests/test_torch_encdec.py) and does not train
    bundle = get_model(cfg.reduced())
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    frames = torch.zeros((1, 8, cfg.reduced().d_model), dtype=torch.bfloat16)
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    logits, _ = bundle.prefill(params, {"frames": frames, "tokens": tokens},
                               bundle.init_cache(1, 8, device="cpu"))
    assert tuple(logits.shape) == (1, 1, cfg.reduced().padded_vocab)
    drawn = []
    monkeypatch.setattr(port_encdec, "init_params_encdec", lambda *a, **k: drawn.append(a))
    with pytest.raises(NotImplementedError, match="token-only pipeline"):
        train(RunConfig(arch=name, steps=1, ckpt_dir=str(tmp_path)), device="cpu")
    assert not drawn


def test_default_device_raises_without_cuda(arch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs")
    _, cfg_t, _, _, _ = arch
    with pytest.raises(RuntimeError, match="CUDA"):
        port_tf.init_params(cfg_t, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model(cfg_t).init_cache(1, 8)
