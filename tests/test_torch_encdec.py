"""The port's encoder-decoder family (SeamlessM4T-medium) against the JAX
package's, on the CPU.

Both packages compute from the same numpy inputs and the same weights: the
JAX package's ``init`` draws them at the ``reduced()`` config (2 encoder and
4 decoder layers, d 128, 4 heads of 32) and ``params_from_numpy`` carries
them into the port.  Two routes: ``flash``, 128 frames and a 128-token
prompt, where the encoder's self-attention and the decoder's prefill take
the flash path in both packages (the JAX side with ``REPRO_FLASH_ATTN=1``,
its Pallas kernel in interpret mode; the port its kernel's plain version,
as a CPU tensor does), and ``chunked``, 96 frames and a 20-token prompt,
where both take the chunked softmax.  The cross-attention takes the
chunked softmax on either route.

Tolerances.  At this size the weights are small (std 0.02, ``wo`` 0.02 /
sqrt(layers)), so a sublayer's output is far smaller than a fixed 2e-2:
the cross-attention's is about 0.01 at its largest.  So every sublayer
output that the prefill and the decode step add to the residual stream
(the encoder's self-attention and MLP, the decoder's self-attention,
cross-attention and MLP), recorded where ``encdec`` calls it, is held
against the JAX function on the same input at rtol 1e-2 with an atol of
1e-2 of the largest value it should have (``close_layer``), as
tests/test_torch_recurrent.py holds its blocks; so are ``encode``,
``_cross_kv``, the cross-attention and the self cache.  The logits are held
at tests/test_arch_smoke.py's 2e-2 (prefill, teacher forcing) and 5e-2
(decode), and besides within 2e-2 of their largest value
(``hold_logits``).  Planted faults (the cross-attention zeroed, its heads
reversed, its softmax scale doubled, decode reading zero rows past the
frames' encoding) must fail those comparisons.  The engine is held
against the JAX engine at tests/test_serve_engine.py's sizes (batch 2,
``enc_len`` 8, prompt 4).
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import attention as jax_attention
from repro.models import encdec as jax_ed
from repro.models import get_model as jax_get_model
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import ARCHS
from repro_torch.launch import serve
from repro_torch.models import attention as port_attention
from repro_torch.models import count_params, get_model
from repro_torch.models import encdec as port_ed
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.serving import ServeEngine
from repro_torch.tree import tree_leaves

ARCH = "seamless-m4t-medium"
B = 2
ROUTES = {"flash": (128, 128), "chunked": (96, 20)}   # route: (S_enc, prompt)
TOL = dict(rtol=2e-2, atol=2e-2)
DECODE_TOL = dict(rtol=5e-2, atol=5e-2)
LOGIT_REL = 2e-2   # max |got - want| of the logits, a share of max |want|
LAYER_REL = 1e-2   # a layer's rtol, and its atol as a share of max |want|
ENC_LEN, PROMPT, MAX_LEN, NEW = 8, 4, 16, 6           # the engine's, as the JAX test's


def f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(f32(got), f32(want), **tol)


def close_layer(got, want):
    w = f32(want)
    close(got, w, rtol=LAYER_REL, atol=LAYER_REL * float(np.abs(w).max()))


def hold_logits(got, want, tol):
    close(got, want, **tol)
    err, top = float(np.abs(f32(got) - f32(want)).max()), float(np.abs(f32(want)).max())
    assert err <= LOGIT_REL * top, (err, top)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, params_to_numpy(tree))


class Sublayers:
    """Records every sublayer call that ``encdec`` makes while it is
    entered: (kind, params, input, what else the JAX function needs,
    output), kind ``encoder`` (non-causal self-attention), ``cross``,
    ``self prefill``, ``self decode`` or ``mlp``."""

    def __init__(self):
        self.calls, self._mp = [], pytest.MonkeyPatch()

    def __enter__(self):
        fwd, pre, dec = (port_attention.gqa_forward, port_attention.gqa_prefill,
                         port_attention.gqa_decode)
        mlp = port_ed._mlp

        def gqa_forward(cfg, p, x, **kw):
            out = fwd(cfg, p, x, **kw)
            if kw.get("cross_kv") is not None:
                self.calls.append(("cross", p, x, kw["cross_kv"], out))
            else:
                assert kw.get("causal") is False
                self.calls.append(("encoder", p, x, None, out))
            return out

        def gqa_prefill(cfg, p, x, cache):
            before = {k: v.clone() for k, v in cache.items()}
            out = pre(cfg, p, x, cache)
            self.calls.append(("self prefill", p, x, before, out[0]))
            return out

        def gqa_decode(cfg, p, x, cache, pos):
            before = {k: v.clone() for k, v in cache.items()}
            out = dec(cfg, p, x, cache, pos)
            self.calls.append(("self decode", p, x, (before, pos), out[0]))
            return out

        def _mlp(cfg, p, x):
            out = mlp(cfg, p, x)
            self.calls.append(("mlp", p, x, None, out))
            return out

        for mod, name, fn in ((port_attention, "gqa_forward", gqa_forward),
                              (port_attention, "gqa_prefill", gqa_prefill),
                              (port_attention, "gqa_decode", gqa_decode),
                              (port_ed, "_mlp", _mlp)):
            self._mp.setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        self._mp.undo()

    def against_jax(self, cfg_j):
        """[(kind, port output, JAX output)]; call it where the route's
        setting is in force (the JAX functions read it as they trace)."""
        fns = {
            "encoder": jax.jit(lambda p, x: jax_attention.gqa_forward(cfg_j, p, x, causal=False)),
            "cross": jax.jit(lambda p, x, kv: jax_attention.gqa_forward(cfg_j, p, x, cross_kv=kv)),
            "self prefill": jax.jit(lambda p, x, c: jax_attention.gqa_prefill(cfg_j, p, x, c)[0]),
            "self decode": jax.jit(
                lambda p, x, c, pos: jax_attention.gqa_decode(cfg_j, p, x, c, pos)[0]),
            "mlp": jax.jit(lambda p, x: jax_ed._mlp(cfg_j, p, x)),
        }
        out = []
        for kind, p, x, extra, got in self.calls:
            args = (to_jax(p), to_jax(x)) + (() if extra is None else (
                (to_jax(extra[0]), extra[1]) if kind == "self decode" else (to_jax(extra),)))
            out.append((kind, got, fns[kind](*args)))
        return out


def bf16(rng, *shape, std=1.0):
    """The same bf16 values as a JAX array and as a CPU tensor."""
    a = np.asarray(jnp.asarray(std * rng.randn(*shape), jnp.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)


@pytest.fixture(scope="module")
def model():
    """(JAX config, port config, JAX bundle, port bundle, JAX params as
    numpy, JAX params, port params)."""
    cfg_j, cfg_t = JAX_ARCHS[ARCH].reduced(), ARCHS[ARCH].reduced()
    assert cfg_t.is_encdec and cfg_t.enc_layers == 2 and cfg_t.n_layers == 4
    jax_model = jax_get_model(cfg_j)
    p_np = jax.tree.map(np.asarray, jax_model.init(jax.random.PRNGKey(0)))
    return (cfg_j, cfg_t, jax_model, get_model(cfg_t), p_np,
            jax.tree.map(jnp.asarray, p_np), params_from_numpy(p_np, device="cpu"))


@pytest.fixture(scope="module", params=sorted(ROUTES))
def run(request, model):
    """Both packages' encode, one layer's cross K/V and cross-attention,
    prefill, one decode step and teacher forcing on the same inputs, along
    one route (see the module's docstring), and every sublayer of the port's
    prefill and decode step beside the JAX function's output on its input."""
    cfg_j, cfg_t, jm, pm, _, pj, pt = model
    S_enc, S = ROUTES[request.param]
    rng = np.random.RandomState(7 + S)
    # frames at the embedding's scale, so that each encoder sublayer moves
    # the stream by a share bf16 can hold (frames of std 1 would round the
    # self-attention's output away in the residual add)
    frames_j, frames_t = bf16(rng, B, S_enc, cfg_t.d_model, std=0.02)
    x_j, x_t = bf16(rng, B, S, cfg_t.d_model)
    tokens = rng.randint(0, cfg_t.vocab, (B, S + 1)).astype(np.int32)
    tok_t = torch.from_numpy(tokens).long()
    cross_j = jax.tree.map(lambda a: a[0], pj["dec"]["cross"])
    cross_t = {k: v[0] for k, v in pt["dec"]["cross"].items()}
    enc_t = port_ed.encode(cfg_t, pt, frames_t)
    kv_t = port_ed._cross_kv(cfg_t, cross_t, enc_t)
    attn_t = port_attention.gqa_forward(cfg_t, cross_t, x_t, cross_kv=kv_t)
    cache_t = pm.init_cache(B, S + 4, enc_len=S_enc, device="cpu")
    with Sublayers() as sub:
        pre_t, ret_t = pm.prefill(pt, {"frames": frames_t, "tokens": tok_t[:, :S]}, cache_t)
        self_after_prefill = {k: v.clone() for k, v in cache_t["self"].items()}
        dec_t, _ = pm.decode_step(pt, tok_t[:, S:], ret_t, S)
    train_t, _ = pm.train_logits(pt, {"frames": frames_t, "tokens": tok_t[:, :S]})
    mp = pytest.MonkeyPatch()
    if request.param == "flash":
        mp.setenv("REPRO_FLASH_ATTN", "1")  # read when the JAX functions trace
    else:
        mp.delenv("REPRO_FLASH_ATTN", raising=False)
    try:
        # jitted (one compile, not one per op), traced under this route's setting
        enc_j = jax.jit(lambda p, f: jax_ed.encode(cfg_j, p, f))(pj, frames_j)
        kv_j = jax.jit(lambda p, e: jax_ed._cross_kv(cfg_j, p, e))(cross_j, enc_j)
        attn_j = jax.jit(lambda p, x, kv: jax_attention.gqa_forward(cfg_j, p, x, cross_kv=kv))(
            cross_j, x_j, kv_j)
        batch_j = {"frames": frames_j, "tokens": tokens[:, :S]}
        pre_j, cache_j = jax.jit(lambda p, b, c: jm.prefill(p, b, c))(
            pj, batch_j, jm.init_cache(B, S + 4, enc_len=S_enc))
        dec_j, cache_j2 = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, S))(
            pj, tokens[:, S:], cache_j)
        train_j, _ = jax.jit(lambda p, b: jm.train_logits(p, b))(
            pj, {"frames": frames_j, "tokens": tokens[:, :S]})
        sublayers = sub.against_jax(cfg_j)
    finally:
        mp.undo()
    return dict(
        S=S, S_enc=S_enc, enc=(enc_t, enc_j), kv=(kv_t, kv_j), attn=(attn_t, attn_j),
        cross_in=(cross_t, x_t, kv_t), pre=(pre_t, pre_j),
        cache=(cache_t, ret_t, self_after_prefill, cache_j), dec=(dec_t, dec_j, cache_j2),
        train=(train_t, train_j), sublayers=sublayers, tokens=tok_t, frames=frames_t)


# ------------------------------------------------------------ the parameters
def _non_norm_count(tree) -> int:
    return sum(a.size for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]
               if "norm" not in jax.tree_util.keystr(path))


def test_init_params_tree_matches_jax(model):
    """The port's init draws the JAX tree's paths, shapes and dtypes (all
    bf16), with the stds of its _nrm; the parameters but the norm scales and
    the vocab's padding number ``count_params``."""
    _, cfg_t, _, pm, p_np, _, _ = model
    pt = pm.init(torch.Generator().manual_seed(0), device="cpu")
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), p_np)
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
                       params_to_numpy(pt))
    assert got == want
    assert abs(float(pt["embed"].float().std()) - 0.02) < 2e-3
    out_std = 0.02 / cfg_t.n_layers ** 0.5
    assert abs(float(pt["enc"]["attn"]["wo"].float().std()) - out_std) < 0.1 * out_std
    assert abs(float(pt["dec"]["mlp"]["w_out"].float().std()) - 0.02) < 2e-3
    assert all(not bool(pt["dec"][n].any()) for n in ("norm1", "norm2", "norm3"))
    pad = (cfg_t.padded_vocab - cfg_t.vocab) * cfg_t.d_model * 2
    assert _non_norm_count(params_to_numpy(pt)) == _non_norm_count(p_np) == \
        count_params(cfg_t) + pad


def test_params_round_trip_bit_for_bit(model):
    *_, p_np, _, pt = model
    want, want_def = jax.tree.flatten(p_np)
    got, got_def = jax.tree.flatten(params_to_numpy(pt))
    assert got_def == want_def
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


# ------------------------------------------------------- layers and the model
def test_encode_matches_jax(run):
    enc_t, enc_j = run["enc"]
    assert tuple(enc_t.shape) == (B, run["S_enc"], enc_j.shape[-1]) and enc_t.dtype == torch.bfloat16
    close_layer(enc_t, enc_j)


def test_cross_kv_matches_jax(run):
    for got, want in zip(*run["kv"]):
        assert tuple(got.shape) == want.shape
        close_layer(got, want)


def test_cross_attention_matches_jax(run):
    got, want = run["attn"]
    assert tuple(got.shape) == want.shape
    close_layer(got, want)


def test_sublayers_match_jax(run, model):
    """Every sublayer output that the port's prefill and decode step add to
    the residual stream, against the JAX function on the same input: each
    layer's contribution, which the logits' tolerance would not see."""
    cfg_t = model[1]
    E, L = cfg_t.enc_layers, cfg_t.n_layers
    kinds = Counter(kind for kind, _, _ in run["sublayers"])
    assert kinds == {"encoder": E, "self prefill": L, "self decode": L, "cross": 2 * L,
                     "mlp": E + 2 * L}
    for kind, got, want in run["sublayers"]:
        assert tuple(got.shape) == want.shape, kind
        close_layer(got, want)


def test_prefill_matches_jax(run):
    """Logits, the self cache (written in place into the caller's) and the
    encoder output, which the prefill returns as long as the frames."""
    pre_t, pre_j = run["pre"]
    cache_t, ret_t, self_t, cache_j = run["cache"]
    hold_logits(pre_t, pre_j, TOL)
    assert ret_t["self"] is cache_t["self"]
    assert tuple(ret_t["enc_out"].shape) == cache_j["enc_out"].shape
    close_layer(ret_t["enc_out"], cache_j["enc_out"])
    for name in ("k", "v"):
        close_layer(self_t[name], cache_j["self"][name])


def test_decode_step_matches_jax(run):
    dec_t, dec_j, cache_j = run["dec"]
    cache_t = run["cache"][0]
    hold_logits(dec_t, dec_j, DECODE_TOL)
    for name in ("k", "v"):
        close_layer(cache_t["self"][name], cache_j["self"][name])


def test_forward_train_matches_jax(run, model):
    got, want = run["train"]
    assert tuple(got.shape) == (B, run["S"], model[1].padded_vocab)
    hold_logits(got, want, TOL)


def _cross_fault(fault):
    """The port's gqa_forward with a fault planted in its cross-attention."""
    fwd = port_attention.gqa_forward

    def gqa_forward(cfg, p, x, **kw):
        kv = kw.get("cross_kv")
        if kv is not None and fault == "cross heads reversed":
            kw["cross_kv"] = (kv[0].flip(2), kv[1].flip(2))
        elif kv is not None and fault == "cross softmax scale doubled":
            kw["cross_kv"] = (2 * kv[0], kv[1])
        out = fwd(cfg, p, x, **kw)
        return out * 0 if kv is not None and fault == "cross-attention zeroed" else out
    return gqa_forward


@pytest.mark.parametrize("fault", ["cross-attention zeroed", "cross heads reversed",
                                   "cross softmax scale doubled",
                                   "enc_out rows past S_enc read"])
def test_planted_fault_fails_the_comparison(run, model, fault):
    """A port with the fault planted fails the comparison that should catch
    it: the prefill's logits (cross-attention zeroed), the cross-attention
    layer (its heads or its softmax scale wrong), the decode step's logits
    (the cross-attention reading 32 zero rows past the frames' encoding, as
    a decode over a longer encoder buffer would)."""
    _, cfg_t, _, pm, _, _, pt = model
    S, frames, tokens = run["S"], run["frames"], run["tokens"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_attention, "gqa_forward", _cross_fault(fault))
        cross_t, x_t, kv_t = run["cross_in"]
        attn = port_attention.gqa_forward(cfg_t, cross_t, x_t, cross_kv=kv_t)
        cache = pm.init_cache(B, S + 4, enc_len=run["S_enc"], device="cpu")
        pre, ret = pm.prefill(pt, {"frames": frames, "tokens": tokens[:, :S]}, cache)
        if fault == "enc_out rows past S_enc read":
            pad = torch.zeros((B, 32, cfg_t.d_model), dtype=torch.bfloat16)
            ret = {**ret, "enc_out": torch.cat([ret["enc_out"], pad], 1)}
        dec, _ = pm.decode_step(pt, tokens[:, S:], ret, S)
    with pytest.raises(AssertionError):
        if fault == "cross-attention zeroed":
            hold_logits(pre, run["pre"][1], TOL)
        elif fault == "enc_out rows past S_enc read":
            hold_logits(dec, run["dec"][1], DECODE_TOL)
        else:
            close_layer(attn, run["attn"][1])


def test_prefill_then_decode_matches_forward(run, model):
    """The port's cache path against its own teacher forcing (as
    tests/test_arch_smoke.py holds the JAX package's)."""
    _, cfg_t, _, pm, _, _, pt = model
    S, tokens, frames = run["S"], run["tokens"], run["frames"]
    full, _ = pm.train_logits(pt, {"frames": frames, "tokens": tokens})
    # a cache whose enc_len exceeds the frames: decode reads the encoding only
    cache = pm.init_cache(B, S + 4, enc_len=run["S_enc"] + 32, device="cpu")
    pre, cache = pm.prefill(pt, {"frames": frames, "tokens": tokens[:, :S]}, cache)
    hold_logits(pre[:, -1], full[:, S - 1], TOL)
    dec, _ = pm.decode_step(pt, tokens[:, S:], cache, S)
    hold_logits(dec[:, -1], full[:, S], DECODE_TOL)


# ------------------------------------------------------------------ the engine
def _engine_batch(cfg, seed: int, S_enc: int):
    rng = np.random.RandomState(seed)
    frames = np.asarray(jnp.asarray(rng.randn(B, S_enc, cfg.d_model), jnp.bfloat16))
    return {"frames": frames, "tokens": rng.randint(0, cfg.vocab, (B, PROMPT)).astype(np.int32)}


def _cache_path(prefill, decode_step, params, cache, frames, seq):
    """A bundle's logits (B, NEW, vocab) along its cache path, fed ``seq``'s
    tokens after the prompt: the prefill's, then each decode step's."""
    out, c = prefill(params, {"frames": frames, "tokens": seq[:, :PROMPT]}, cache)
    steps = [f32(out)[:, -1]]
    for i in range(NEW - 1):
        out, c = decode_step(params, seq[:, PROMPT + i:PROMPT + i + 1], c, PROMPT + i)
        steps.append(f32(out)[:, -1])
    return np.stack(steps, 1)


@pytest.mark.parametrize("S_enc, exact", [(ENC_LEN, False), (5, True), (ENC_LEN + 3, True)],
                         ids=["frames=enc_len", "frames<enc_len", "frames>enc_len"])
def test_greedy_tokens_match_jax_engine(model, S_enc, exact):
    """Greedy tokens against the JAX engine's.  A position is clear where
    the JAX teacher's top-2 logit margin exceeds twice the gap between the
    JAX package's own two routes to those logits (its cache path, fed the
    JAX engine's tokens, and teacher forcing): a limit that does not grow
    with the port's error.  At this size the logits spread by about 0.2 and
    a margin of one bf16 step (0.0039) occurs.  The port's cache path, fed
    the JAX engine's tokens, must give the JAX token at every clear position,
    and at least half the positions must be clear.  The engines' own tokens
    must be equal up to where they first part, which must not be clear; with
    frames shorter and longer than ``enc_len`` (no near tie on the way) they
    must be equal throughout."""
    _, cfg_t, jm, pm, _, pj, pt = model
    V = cfg_t.vocab
    batch = _engine_batch(cfg_t, 3 + S_enc, S_enc)
    want = JaxServeEngine(jm, pj, max_len=MAX_LEN, batch=B, enc_len=ENC_LEN).generate(
        {k: jnp.asarray(v) for k, v in batch.items()}, max_new_tokens=NEW)
    got = ServeEngine(pm, pt, max_len=MAX_LEN, batch=B, enc_len=ENC_LEN, device="cpu").generate(
        batch, max_new_tokens=NEW)
    want_tokens = np.asarray(want.tokens)
    assert got.tokens.shape == want_tokens.shape == (B, NEW)
    assert got.tokens.dtype == np.int32 and got.steps == want.steps == NEW

    seq = np.concatenate([batch["tokens"], want_tokens[:, :-1]], 1)
    frames_j = jnp.asarray(batch["frames"])
    frames_t = torch.from_numpy(batch["frames"].view(np.uint16).copy()).view(torch.bfloat16)
    tf_j = np.asarray(jax.jit(lambda p, b: jm.train_logits(p, b)[0])(
        pj, {"frames": frames_j, "tokens": seq}), np.float32)[:, PROMPT - 1:, :V]
    step_j = jax.jit(lambda p, t, c, pos: jm.decode_step(p, t, c, pos))
    cp_j = _cache_path(jax.jit(lambda p, b, c: jm.prefill(p, b, c)),
                       lambda p, t, c, pos: step_j(p, t, c, pos), pj,
                       jm.init_cache(B, MAX_LEN, enc_len=ENC_LEN), frames_j, seq)[..., :V]
    cp_t = _cache_path(pm.prefill, pm.decode_step, pt,
                       pm.init_cache(B, MAX_LEN, enc_len=ENC_LEN, device="cpu"), frames_t,
                       torch.from_numpy(seq).long())[..., :V]
    assert (cp_j.argmax(-1) == want_tokens).all()   # the JAX engine's own route
    route_gap = float(np.abs(cp_j - tf_j).max())
    top2 = np.sort(tf_j, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * route_gap
    assert int(clear.sum()) >= B * NEW // 2, (int(clear.sum()), route_gap)
    assert (tf_j.argmax(-1)[clear] == want_tokens[clear]).all()
    assert (cp_t.argmax(-1)[clear] == want_tokens[clear]).all(), (S_enc, route_gap)

    if exact:
        np.testing.assert_array_equal(got.tokens, want_tokens)
    assert (got.tokens[:, 0] == want_tokens[:, 0]).all()   # the prefill's tokens
    for b in range(B):
        for i in range(NEW):
            if got.tokens[b, i] != want_tokens[b, i]:
                assert not clear[b, i], (S_enc, b, i, route_gap)
                break


@pytest.fixture(scope="module")
def engine(model):
    _, cfg_t, _, pm, _, _, pt = model
    return ServeEngine(pm, pt, max_len=MAX_LEN, batch=B, enc_len=ENC_LEN, device="cpu")


def test_cache_shapes_stable_and_cleared(engine, model):
    cfg_t = model[1]
    shapes = lambda c: [tuple(t.shape) for t in tree_leaves(c)]
    before, buffers = shapes(engine._cache0), tree_leaves(engine._cache0)
    assert tuple(engine._cache0["enc_out"].shape) == (B, ENC_LEN, cfg_t.d_model)
    for seed, S_enc in ((0, ENC_LEN), (1, 3), (2, ENC_LEN + 5), (3, ENC_LEN)):
        res = engine.generate(_engine_batch(cfg_t, seed, S_enc), max_new_tokens=3)
        assert res.tokens.shape == (B, 3)
        assert shapes(engine._cache0) == before
        # the engine's own buffers, cleared after each request
        now = tree_leaves(engine._cache0)
        assert all(a is b for a, b in zip(now, buffers))
        assert not any(bool(t.any()) for t in now)


def test_enc_len_defaults_to_max_len(model):
    _, cfg_t, _, pm, _, _, pt = model
    assert tuple(pm.init_cache(B, MAX_LEN, device="cpu")["enc_out"].shape) == \
        (B, MAX_LEN, cfg_t.d_model)
    eng = ServeEngine(pm, pt, max_len=MAX_LEN, batch=B, device="cpu")
    assert eng._cache0["enc_out"].shape[1] == MAX_LEN
    assert eng.generate(_engine_batch(cfg_t, 5, MAX_LEN), max_new_tokens=2).tokens.shape == (B, 2)


def test_cuda_default_raises_without_a_card(model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs")
    _, cfg_t, _, pm, _, _, pt = model
    with pytest.raises(RuntimeError, match="CUDA"):
        pm.init(torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        pm.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(pm, pt, max_len=MAX_LEN, batch=B, enc_len=ENC_LEN)


def test_serve_driver_runs_on_cpu(capsys):
    serve.main(["--device", "cpu", "--arch", ARCH, "--batch", "2", "--prompt-len", "8",
                "--max-new-tokens", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"[serve] {ARCH}: prefill") and "CPU, reduced config" in lines[0]
    assert lines[1].startswith("[serve] sample tokens:")
