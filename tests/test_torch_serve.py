"""The port's ServeEngine and serving driver on the CPU, against the JAX
package's engine.

Both engines serve reduced minitron-4b from the same weights and prompts,
greedy: a 128-token prompt (the prefill takes the flash path in both; the
JAX side with ``REPRO_FLASH_ATTN=1``, its Pallas kernel in interpret mode)
and a 100-token prompt (the chunked softmax in both).  Greedy tokens must be
equal wherever the JAX teacher-forced top-2 logit margin exceeds twice the
measured gap between the two packages' teacher-forced logits (each engine's
cache path rounds once more than teacher forcing).  Where the margin is
that small the engines may part ways, and their contexts differ from there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import get_model as jax_get_model
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import ARCHS
from repro_torch.launch import serve
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import ServeEngine

ARCH = "minitron-4b"
B, NEW = 2, 8
PROMPTS = (128, 100)


def _shapes(cache):
    return [[{k: tuple(t.shape) for k, t in unit.items()} for unit in seg] for seg in cache]


@functools.lru_cache(maxsize=None)
def _weights():
    """The JAX package's weights for reduced minitron-4b, as numpy."""
    model = jax_get_model(JAX_ARCHS[ARCH].reduced())
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))


def _prompt(S, seed=11):
    return np.random.RandomState(seed + S).randint(0, 512, (B, S)).astype(np.int32)


@pytest.mark.parametrize("S", PROMPTS)
def test_greedy_tokens_match_jax_engine(monkeypatch, S):
    monkeypatch.setenv("REPRO_FLASH_ATTN", "1")  # read when the JAX functions trace
    cfg_j, cfg_t = JAX_ARCHS[ARCH].reduced(), ARCHS[ARCH].reduced()
    model, port = jax_get_model(cfg_j), get_model(cfg_t)
    pj = jax.tree.map(jnp.asarray, _weights())
    pt = params_from_numpy(_weights(), device="cpu")
    tokens = _prompt(S)
    want = JaxServeEngine(model, pj, max_len=S + NEW, batch=B).generate(
        {"tokens": tokens}, max_new_tokens=NEW)
    got = ServeEngine(port, pt, max_len=S + NEW, batch=B, device="cpu").generate(
        {"tokens": tokens}, max_new_tokens=NEW)
    assert got.tokens.shape == want.tokens.shape == (B, NEW)
    assert got.tokens.dtype == np.int32 and got.steps == want.steps == NEW
    assert got.prefill_s > 0 and got.decode_s > 0

    # both packages' teacher forcing over the JAX engine's answer
    seq = np.concatenate([tokens, want.tokens[:, :-1]], 1)
    tf_j = np.asarray(jax.jit(lambda p, b: model.train_logits(p, b)[0])(pj, {"tokens": seq}),
                      np.float32)[:, S - 1:, :cfg_t.vocab]
    tf_t = port.train_logits(pt, {"tokens": torch.from_numpy(seq).long()})[0]
    gap = float(np.abs(tf_t.float().numpy()[:, S - 1:, :cfg_t.vocab] - tf_j).max())
    top2 = np.sort(tf_j, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    # the teacher's argmax is the JAX engine's token wherever the margin is clear
    clear = margin > 2 * gap
    assert (tf_j.argmax(-1)[clear] == want.tokens[clear]).all()
    compared = 0
    for b in range(B):
        for i in range(NEW):
            if got.tokens[b, i] != want.tokens[b, i]:
                # only a near tie may part the engines; the contexts differ from here
                assert not clear[b, i], (S, b, i, margin[b, i], gap)
                break
            compared += int(clear[b, i])
    assert compared >= B * NEW // 2, (compared, gap)


def test_engine_passes_inputs_embeds(monkeypatch):
    """The engine hands the bundle's prefill the whole batch, as the JAX
    engine does: with ``inputs_embeds`` its first tokens are the bundle's
    own prefill's with the embeddings, and the JAX engine's on the same
    batch (reduced minitron-4b, 2 x 16 prompt tokens, seeded bf16
    embeddings).  Before, the port's engine dropped the embeddings and
    answered [116, 315] where the prefill with them gives [503, 414]."""
    monkeypatch.delenv("REPRO_FLASH_ATTN", raising=False)
    cfg_j, cfg_t = JAX_ARCHS[ARCH].reduced(), ARCHS[ARCH].reduced()
    model, port = jax_get_model(cfg_j), get_model(cfg_t)
    pj = jax.tree.map(jnp.asarray, _weights())
    pt = params_from_numpy(_weights(), device="cpu")
    tokens = _prompt(16, seed=13)
    rng = np.random.RandomState(14)
    embeds = np.asarray(jnp.asarray(rng.randn(B, 16, cfg_t.d_model), jnp.bfloat16))
    embeds_t = torch.from_numpy(embeds.view(np.uint16).copy()).view(torch.bfloat16)
    want = JaxServeEngine(model, pj, max_len=16 + NEW, batch=B).generate(
        {"tokens": tokens, "inputs_embeds": jnp.asarray(embeds)}, max_new_tokens=2)
    engine = ServeEngine(port, pt, max_len=16 + NEW, batch=B, device="cpu")
    first = {}
    for name, x in (("numpy", embeds), ("tensor", embeds_t)):
        first[name] = engine.generate({"tokens": tokens, "inputs_embeds": x},
                                      max_new_tokens=2).tokens[:, 0]
    plain = engine.generate({"tokens": tokens}, max_new_tokens=2).tokens[:, 0]
    logits, _ = port.prefill(pt, {"tokens": torch.from_numpy(tokens).long(),
                                  "inputs_embeds": embeds_t},
                             port.init_cache(B, 16 + NEW, device="cpu"))
    bundle_first = logits[:, -1, :cfg_t.vocab].float().argmax(-1).numpy()
    for got in first.values():
        np.testing.assert_array_equal(got, bundle_first)
        np.testing.assert_array_equal(got, np.asarray(want.tokens)[:, 0])
    assert not np.array_equal(plain, bundle_first)  # the embeddings change the answer


@pytest.fixture(scope="module")
def engine():
    cfg = ARCHS[ARCH].reduced()
    bundle = get_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    return ServeEngine(bundle, params, max_len=max(PROMPTS) + NEW, batch=B, device="cpu")


def test_cache_shapes_stable_and_cleared(engine):
    before = _shapes(engine._cache0)
    buffers = [t for seg in engine._cache0 for unit in seg for t in unit.values()]
    for S in PROMPTS:
        engine.generate({"tokens": _prompt(S)}, max_new_tokens=NEW)
        assert _shapes(engine._cache0) == before
        # the engine's own buffer, cleared after each request
        now = [t for seg in engine._cache0 for unit in seg for t in unit.values()]
        assert all(a is b for a, b in zip(now, buffers))
        assert not any(t.any() for t in now)


def test_sampling_is_seeded(engine):
    engine.temperature = 1.0
    try:
        tokens = _prompt(16, seed=12)
        a = engine.generate({"tokens": tokens}, max_new_tokens=4, seed=3)
        b = engine.generate({"tokens": tokens}, max_new_tokens=4, seed=3)
    finally:
        engine.temperature = 0.0
    assert np.array_equal(a.tokens, b.tokens)
    assert a.tokens.min() >= 0 and a.tokens.max() < 512


def test_serve_driver_runs_on_cpu(capsys):
    serve.main(["--device", "cpu", "--arch", ARCH, "--batch", "2", "--prompt-len", "16",
                "--max-new-tokens", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"[serve] {ARCH}: prefill") and "CPU, reduced config" in lines[0]
    assert lines[1].startswith("[serve] sample tokens:")


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "phi3.5-moe-42b-a6.6b"])
def test_serve_driver_runs_moe_archs_on_cpu(capsys, arch):
    serve.main(["--device", "cpu", "--arch", arch, "--batch", "2", "--prompt-len", "16",
                "--max-new-tokens", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"[serve] {arch}: prefill") and "CPU, reduced config" in lines[0]
    assert lines[1].startswith("[serve] sample tokens:")


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs")
    cfg = ARCHS[ARCH].reduced()
    bundle = get_model(cfg)
    params = bundle.init(torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(bundle, params, max_len=16, batch=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", ARCH])
