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
"""

import contextlib

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
