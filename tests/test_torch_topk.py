"""The port's top-k against the JAX package's `_topk_from_scores`
(jax.lax.top_k): bit for bit, ties included (higher score first, lower
doc index first on ties), with the dead column 0 and the score > 0 mask."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ir.ops import scoring as jscoring

from tpu_ir_torch.ops import scoring


def _both(scores: np.ndarray, k: int):
    ws, wd = jscoring._topk_from_scores(jnp.asarray(scores), k)
    before = scores.copy()
    gs, gd = scoring._topk_from_scores(torch.from_numpy(scores), k)
    np.testing.assert_array_equal(scores, before)   # scores left as given
    return (np.asarray(ws), np.asarray(wd)), (gs.numpy(), gd.numpy())


def _assert_same(scores, k):
    (ws, wd), (gs, gd) = _both(scores, k)
    assert gs.dtype == np.float32 and gd.dtype == np.int32
    np.testing.assert_array_equal(gs.view(np.int32), ws.view(np.int32))
    np.testing.assert_array_equal(gd, wd)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("levels", [2, 5, 50])
def test_planted_ties(seed, levels):
    rng = np.random.default_rng(seed)
    scores = (rng.integers(0, levels, (12, 97)) * 0.37).astype(np.float32)
    _assert_same(scores, 10)


def test_all_zero_rows_and_k_above_matches():
    scores = np.zeros((4, 30), np.float32)
    scores[1, [3, 9]] = 1.5            # two matches, k = 10
    scores[2, 5:] = 2.0                # a long exact tie
    scores[3, 0] = 9.0                 # only the dead column
    _assert_same(scores, 10)
    (_, _), (gs, gd) = _both(scores, 10)
    assert gd[0].tolist() == [0] * 10 and gs[0].tolist() == [0.0] * 10
    assert gd[1].tolist()[:2] == [3, 9] and gd[1, 2:].tolist() == [0] * 8
    assert gd[2].tolist() == list(range(5, 15))
    assert gd[3].tolist() == [0] * 10


@pytest.mark.parametrize("k", [1, 3, 10, 29, 30, 64])
def test_k_against_width(k):
    rng = np.random.default_rng(k)
    scores = rng.random((5, 30)).astype(np.float32)
    scores[:, 7] = scores[:, 8]        # exact float ties
    _assert_same(scores, k)


def test_negative_and_tiny_scores():
    # smallest normal floats only: XLA's CPU backend flushes subnormals
    scores = np.array([[0.0, -1.0, 2e-38, 3.0, -0.0, 1e-30, 3.0]],
                      np.float32)
    _assert_same(scores, 7)


def test_real_valued_scores_random():
    rng = np.random.default_rng(9)
    scores = rng.standard_normal((64, 257)).astype(np.float32)
    scores[:, ::17] = scores[:, 1:2]   # ties across the row
    _assert_same(scores, 10)
