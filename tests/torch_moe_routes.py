"""Route-flip handling for the MoE model tests (a helper, not a test file).

At model level the port and the JAX package feed each MoE layer inputs
that differ by bf16 rounding, so where a token's K-th and (K+1)-th gates
are nearly equal the two may route it to different experts, and its logits
then differ by more than rounding.  The tests record the port's gates at
every MoE layer (:func:`recorded_margins`) and hold every position whose
margin is at least ``NEAR_TIE`` at every layer to the tolerance; the
positions under it (at most ``MAX_NEAR_SHARE`` of them) are left out.  On
the test inputs the positions past the tolerance are exactly the ones with
the smallest margins (below 5e-5); the next margins up are above 9e-5.

Gradients cannot leave a position out: a flipped route changes its token's
hidden state in every later layer and its cotangent in every earlier one,
so it reaches every leaf.  The training tests therefore record JAX's routes
inside its jitted program (:func:`jax_recorded_routes`, every call of
``jax.lax.top_k``), compare the port's with them layer by layer, and where
they differ, at near ties only, have the port take JAX's experts at its own
gates (:func:`forced_routes`), naming each such position and its margin.
"""

import contextlib

import jax
import numpy as np
import torch

from repro_torch.models import moe

NEAR_TIE = 2.5e-4
MAX_NEAR_SHARE = 0.05


@contextlib.contextmanager
def recorded_margins():
    """Yields a list that collects, for every call of ``moe.route``, the
    (B, S) gap between each token's K-th and (K+1)-th gate."""
    margins = []
    route = moe.route

    def recording(cfg, logits):
        gates = torch.softmax(logits, dim=-1).sort(dim=-1, descending=True).values
        margins.append(gates[..., cfg.top_k - 1] - gates[..., cfg.top_k])
        return route(cfg, logits)

    moe.route = recording
    try:
        yield margins
    finally:
        moe.route = route


def assert_close_off_ties(got, want, margins, **tol):
    """``got`` and ``want`` (B, S, ...) at rtol/atol ``tol`` at every
    position whose least margin over ``margins`` (a list of (B, S)) is at
    least ``NEAR_TIE``."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    near = torch.stack(margins).amin(0).numpy() < NEAR_TIE
    assert near.shape == got.shape[:2]
    assert near.mean() <= MAX_NEAR_SHARE, f"{int(near.sum())} near-tie positions"
    np.testing.assert_allclose(got[~near], want[~near], **tol)
    return int(near.sum())


@contextlib.contextmanager
def jax_recorded_routes():
    """Yields a list that collects, as numpy arrays, the ``(gates, experts)``
    (B, S, K) of every ``jax.lax.top_k`` that the JAX package runs while
    active (the MoE layers' routing), reported from inside a jitted program:
    a forward pass and its remat recompute each report.  Only programs traced
    while active report."""
    calls = []
    top_k = jax.lax.top_k

    def recording(x, k):
        w, e = top_k(x, k)
        jax.debug.callback(lambda w, e: calls.append((np.asarray(w), np.asarray(e))), w, e)
        return w, e

    jax.lax.top_k = recording
    try:
        yield calls
    finally:
        jax.lax.top_k = top_k


def routes_by_layer(calls, n_layers: int):
    """JAX's recorded ``(gates, experts)`` grouped into ``n_layers`` MoE
    layers, in report order: every call of a layer (its forward and any
    recompute) must report the same experts.  Two layers route almost every
    token differently, so the distinct expert arrays are the layers."""
    layers = []
    for w, e in calls:
        if not any(np.array_equal(e, le) for _, le in layers):
            layers.append((w, e))
    assert len(layers) == n_layers, (
        f"{len(calls)} top_k calls gave {len(layers)} distinct routes, not one per MoE layer "
        f"({n_layers}): a recompute chose other experts than its forward")
    return layers


@contextlib.contextmanager
def forced_routes(want):
    """While active, every ``moe.route`` call is matched to the layer of
    ``want`` (JAX's ``(gates, experts)``, one pair a layer) whose experts it
    agrees with most; at each position where its own ordered top-k differs,
    it takes JAX's experts, weighted by its own gates at those experts and
    normalised as ``route`` does.  Yields a list of ``(layer, b, s, margin,
    gap)`` for each position so taken (once a layer, however often it is
    recomputed): ``margin`` the least gap between neighbours of its K + 1
    largest gates, how near the tie was; ``gap`` the layer's largest
    difference between its gates and JAX's at JAX's experts, over all
    positions, the packages' rounding apart."""
    flips, seen = [], set()
    route = moe.route

    def forcing(cfg, logits):
        top_w, top_e = route(cfg, logits)
        i = int(np.argmin([(e != top_e.cpu().numpy()).any(-1).sum() for _, e in want]))
        jax_e = torch.from_numpy(np.array(want[i][1])).to(top_e.device, top_e.dtype)
        diff = (top_e != jax_e).any(-1)
        gates = torch.softmax(logits, dim=-1)
        if i not in seen:
            seen.add(i)
            g = gates.detach()
            gap = float((g.gather(-1, jax_e).cpu() - torch.from_numpy(np.array(want[i][0])))
                        .abs().max())
            near = g.sort(dim=-1, descending=True).values[..., :cfg.top_k + 1]
            margins = (near[..., :-1] - near[..., 1:]).amin(-1)
            flips.extend((i, b, s, float(margins[b, s]), gap)
                         for b, s in diff.nonzero().tolist())
        if not bool(diff.any()):
            return top_w, top_e
        forced = gates.gather(-1, jax_e)
        forced = forced / torch.clamp(forced.sum(-1, keepdim=True), min=1e-9)
        return (torch.where(diff[..., None], forced, top_w),
                torch.where(diff[..., None], jax_e, top_e))

    moe.route = forcing
    try:
        yield flips
    finally:
        moe.route = route


def assert_near_ties(flips, n_positions: int) -> None:
    """Every forced position was a tie within rounding: its margin at most
    twice its layer's gap to JAX's gates (two gates each off by at most the
    gap can change order only across a margin under twice it), and they are
    at most ``MAX_NEAR_SHARE`` of the ``n_positions`` routed."""
    far = [f for f in flips if f[3] > 2 * f[4]]
    assert not far, f"routes differ from JAX's away from a tie within rounding: {far}"
    assert len(flips) <= MAX_NEAR_SHARE * n_positions, f"{len(flips)} flipped positions"
