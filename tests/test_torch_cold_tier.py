"""The cold-tier kernel's plain twin (what the wrapper runs on a CPU tensor)
against the JAX package: against `xla_cold_tier` and
`pallas_cold_tier(interpret=True)` of experiments/cold_tier_bench.py for
a one-tier table, and against the cold stage of `_tiered_scores` (every
tier, TF-IDF and BM25) on a real tiered layout; and bitwise against a
numpy float32 sum in (tier, l) order at the card's edge cases.

Tolerance: rtol 1e-5, atol 1e-6. XLA and torch may round ln and the BM25
quotient differently in the last place; the kernel itself is held bitwise
against the twin on the card (chip_smoke.py, tests/test_torch_cuda.py)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ir.ops import scoring as jscoring

import tpu_ir_torch
from tpu_ir_torch.ops import cold_tier, scoring
from tpu_ir_torch.search import layout

RTOL, ATOL = 1e-5, 1e-6
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

NUM_DOCS = 60
SEEDS = [0, 1, 2]

# experiments/cold_tier_bench.py, loaded by path in a child interpreter:
# this suite's conftest keeps only JAX's CPU backend, and without the TPU
# platform registered the Pallas import fails here
_CHILD = """
import importlib.util, sys
import jax.numpy as jnp, numpy as np
spec = importlib.util.spec_from_file_location(
    "cold_tier_bench", "experiments/cold_tier_bench.py")
bench = importlib.util.module_from_spec(spec)
spec.loader.exec_module(bench)
z = np.load(sys.argv[1])
out = {}
for s in z["seeds"]:
    args = [jnp.asarray(z[f"{name}{s}"]) for name in
            ("rows", "in_tier", "q_w", "tdocs", "ttfs")]
    n = int(z["num_docs"])
    out[f"xla{s}"] = np.asarray(bench.xla_cold_tier(*args, num_docs=n))
    out[f"pallas{s}"] = np.asarray(bench.pallas_cold_tier(
        *args, num_docs=n, interpret=True))
np.savez(sys.argv[2], **out)
"""


def _tier_inputs(seed, b=8, l=3, v_t=6, cap=16):
    """One tier's arrays and a query block with out-of-tier slots, pad
    slots, a duplicated term and an all-zero tier row."""
    rng = np.random.default_rng(seed)
    tdocs = np.zeros((v_t, cap), np.int32)
    ttfs = np.zeros((v_t, cap), np.int32)
    for r in range(v_t - 1):                      # the last row: all zero
        n = int(rng.integers(1, cap + 1))
        tdocs[r, :n] = np.sort(rng.choice(NUM_DOCS, n, replace=False) + 1)
        ttfs[r, :n] = rng.integers(1, 20, n)
    rows = rng.integers(0, v_t, (b, l)).astype(np.int32)
    in_tier = rng.random((b, l)) < 0.7
    q_w = (rng.random((b, l)) + 0.1).astype(np.float32)
    rows[2, 1] = rows[2, 0]                       # a duplicated term
    in_tier[2, :2] = True
    in_tier[4] = False                            # a query outside the tier
    rows[5, 0], in_tier[5, 0] = v_t - 1, True     # the all-zero row
    rows[6, 2] = 10_000                           # out of range, not in tier
    in_tier[6, 2] = False
    return rows, in_tier, q_w, tdocs, ttfs


@pytest.fixture(scope="module")
def jax_tier_scores(tmp_path_factory):
    """{(kind, seed): scores} of xla_cold_tier and the interpreted Pallas
    kernel, from one child run."""
    d = tmp_path_factory.mktemp("cold")
    arrays = {"seeds": np.array(SEEDS), "num_docs": NUM_DOCS}
    for s in SEEDS:
        rows, in_tier, q_w, tdocs, ttfs = _tier_inputs(s)
        # the JAX side gets rows in range: its gathers would clamp them
        rows = np.where(in_tier, rows, 0)
        arrays.update({f"rows{s}": rows, f"in_tier{s}": in_tier,
                       f"q_w{s}": q_w, f"tdocs{s}": tdocs,
                       f"ttfs{s}": ttfs})
    np.savez(d / "in.npz", **arrays)
    r = subprocess.run([sys.executable, "-c", _CHILD, str(d / "in.npz"),
                        str(d / "out.npz")], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(d / "out.npz") as z:
        return {(k, s): z[f"{k}{s}"] for k in ("xla", "pallas")
                for s in SEEDS}


TIER = 0    # a one-tier table; other terms sit in tier -1 or past it


def _q_tier(in_tier, seed=0):
    """Per-term tier ids: TIER where `in_tier`, another tier elsewhere."""
    other = np.random.default_rng(seed).choice([-1, 1, 3], in_tier.shape)
    return torch.from_numpy(np.where(in_tier, TIER, other).astype(np.int32))


def _wrapper(scores, rows, in_tier, q_w, tdocs, ttfs, **kw):
    cold_tier.cold_stage(scores, _q_tier(in_tier), torch.from_numpy(rows),
                         torch.from_numpy(q_w),
                         cold_tier.TierTable([torch.from_numpy(tdocs)],
                                             [torch.from_numpy(ttfs)]), **kw)


def _twin(rows, in_tier, q_w, tdocs, ttfs, **kw):
    scores = torch.zeros((rows.shape[0], NUM_DOCS + 1))
    tpu_ir_torch.reset_kernel_launches()
    _wrapper(scores, rows, in_tier, q_w, tdocs, ttfs, **kw)
    assert tpu_ir_torch.kernel_launches()["cold_tier"] == 0  # CPU: twin
    return scores.numpy()


@pytest.mark.parametrize("kind", ["xla", "pallas"])
@pytest.mark.parametrize("seed", SEEDS)
def test_twin_matches_jax_tier(jax_tier_scores, kind, seed):
    rows, in_tier, q_w, tdocs, ttfs = _tier_inputs(seed)
    got = _twin(rows, in_tier, q_w, tdocs, ttfs)
    want = jax_tier_scores[(kind, seed)]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got[4] == 0).all() and got[:, 0].max() == 0
    assert got.any()


def test_twin_accumulates_into_scores():
    rows, in_tier, q_w, tdocs, ttfs = _tier_inputs(3)
    once = _twin(rows, in_tier, q_w, tdocs, ttfs)
    start = np.random.default_rng(3).random(once.shape, np.float32)
    scores = torch.from_numpy(start.copy())
    _wrapper(scores, rows, in_tier, q_w, tdocs, ttfs)
    np.testing.assert_allclose(scores.numpy(), start + once, rtol=RTOL,
                               atol=ATOL)
    untouched = once == 0
    np.testing.assert_array_equal(scores.numpy()[untouched],
                                  start[untouched])


def test_out_of_range_rows_are_clamped_into_the_tier():
    rows, in_tier, q_w, tdocs, ttfs = _tier_inputs(5)
    in_tier[0, :2] = True
    rows[0, 0], rows[0, 1] = 10_000, -3
    clamped = rows.copy()
    clamped[0, 0], clamped[0, 1] = len(tdocs) - 1, 0
    np.testing.assert_array_equal(_twin(rows, in_tier, q_w, tdocs, ttfs),
                                  _twin(clamped, in_tier, q_w, tdocs, ttfs))


def test_wrapper_rejects_bad_inputs():
    rows, in_tier, q_w, tdocs, ttfs = _tier_inputs(4)
    q_tier = _q_tier(in_tier)
    rows, q_w, tdocs, ttfs = (torch.from_numpy(a)
                              for a in (rows, q_w, tdocs, ttfs))
    tiers = cold_tier.TierTable([tdocs], [ttfs])
    scores = torch.zeros((rows.shape[0], NUM_DOCS + 1))
    with pytest.raises(ValueError, match="int32 tier arrays"):
        cold_tier.cold_stage(scores, q_tier, rows, q_w,
                             cold_tier.TierTable([tdocs.long()], [ttfs]))
    with pytest.raises(ValueError, match="int32 term tiers"):
        cold_tier.cold_stage(scores, q_tier.long(), rows, q_w, tiers)
    with pytest.raises(ValueError, match="float32"):
        cold_tier.cold_stage(scores.double(), q_tier, rows, q_w, tiers)
    with pytest.raises(ValueError, match=r"\[B, L\]"):
        cold_tier.cold_stage(scores, q_tier, rows[:, :2], q_w, tiers)
    with pytest.raises(ValueError, match="contiguous"):
        cold_tier.cold_stage(scores.t().contiguous().t(), q_tier, rows, q_w,
                             tiers)
    with pytest.raises(ValueError, match="dl_norm"):
        cold_tier.cold_stage(scores, q_tier, rows, q_w, tiers,
                             dl_norm=torch.ones(NUM_DOCS))
    with pytest.raises(ValueError, match=r"\[V_t, P_t\]"):
        cold_tier.TierTable([tdocs], [ttfs[:, :3].contiguous()])
    with pytest.raises(ValueError, match="tfs arrays"):
        cold_tier.TierTable([tdocs, tdocs], [ttfs])
    over = cold_tier.MAX_TIERS + 1
    with pytest.raises(ValueError, match=f"at most {cold_tier.MAX_TIERS}"):
        cold_tier.TierTable([tdocs] * over, [ttfs] * over)
    assert len(cold_tier.TierTable([tdocs] * (over - 1),
                                   [ttfs] * (over - 1))) == over - 1


def _layout(seed, num_docs=120, vocab=300, n_tok=6000):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab - 20 + 1)
    terms = rng.choice(vocab - 20, n_tok, p=p / p.sum())
    docs = rng.integers(1, num_docs + 1, n_tok)
    key, tf = np.unique(terms.astype(np.int64) * (num_docs + 1) + docs,
                        return_counts=True)
    pair_term = (key // (num_docs + 1)).astype(np.int32)
    pair_doc = (key % (num_docs + 1)).astype(np.int32)
    df = np.bincount(pair_term, minlength=vocab).astype(np.int32)
    doc_len = np.bincount(pair_doc, weights=tf,
                          minlength=num_docs + 1).astype(np.int32)
    tiers = layout.build_tiered_layout(pair_doc, tf.astype(np.int32), df,
                                       num_docs=num_docs)
    q = rng.integers(0, vocab, (24, 4)).astype(np.int32)
    q[1, 2:] = -1                                   # padding
    q[3] = -1                                       # an empty query
    q[4, 1] = q[4, 0]                               # a duplicated term
    q[5, 0] = vocab + 9                             # out of vocabulary
    q[6, 0] = vocab - 1                             # a df == 0 term
    return tiers, df, doc_len, num_docs, q


@pytest.mark.parametrize("scoring_name", ["tfidf", "bm25"])
@pytest.mark.parametrize("seed", [0, 1])
def test_cold_stage_matches_jax_tiered(scoring_name, seed):
    """Every tier in order: the port's cold stage against JAX's
    `_tiered_scores` with the hot stage skipped (skip_hot=True)."""
    tiers, df, doc_len, n, q = _layout(seed)
    assert len(tiers.tier_docs) >= 3 and tiers.num_hot > 1
    k1, b = 0.9, 0.4
    j_dl = 1.0 - b + b * jnp.asarray(doc_len, jnp.float32) / jnp.maximum(
        jnp.sum(jnp.asarray(doc_len, jnp.float32)) / n, 1e-9)
    if scoring_name == "bm25":
        j_qw = jscoring.bm25_idf_weights(jnp.asarray(df), n)
        cell = lambda tfs, docs: jscoring.bm25_saturation(  # noqa: E731
            tfs, j_dl[docs], k1=k1)
    else:
        j_qw = jscoring.idf_weights(jnp.asarray(df), n)
        cell = lambda tfs, docs: jscoring._lntf(tfs)  # noqa: E731
    want = jscoring._tiered_scores(
        jnp.asarray(q), jnp.asarray(tiers.hot_rank),
        jnp.asarray(tiers.hot_dense()), jnp.asarray(tiers.tier_of),
        jnp.asarray(tiers.row_of), tuple(map(jnp.asarray, tiers.tier_docs)),
        tuple(map(jnp.asarray, tiers.tier_tfs)), j_qw, num_docs=n,
        hot_weight_fn=jscoring._lntf, cold_weight_fn=cell, skip_hot=True)

    dev = torch.device("cpu")
    df_t = torch.from_numpy(df)
    q_weight = (scoring.bm25_idf_weights(df_t, n) if scoring_name == "bm25"
                else scoring.idf_weights(df_t, n))
    dl_norm = (scoring.bm25_dl_norm(torch.from_numpy(doc_len), n, b)
               if scoring_name == "bm25" else None)
    terms = scoring.tiered_terms(
        torch.from_numpy(q), layout.upload_index(tiers.hot_rank, dev),
        layout.upload_index(tiers.tier_of, dev),
        layout.upload_index(tiers.row_of, dev), q_weight)
    table = cold_tier.TierTable(
        [layout.upload_index(a, dev) for a in tiers.tier_docs],
        [layout.upload_index(a, dev) for a in tiers.tier_tfs])
    got = torch.zeros((q.shape[0], n + 1))
    scoring.cold_stage(got, terms, table, dl_norm=dl_norm, k1=k1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert (got[3] == 0).all() and got.numpy().any()
    # the whole-stage twin is the per-tier loop, bitwise
    loop = torch.zeros_like(got)
    for t, (tdocs, ttfs) in enumerate(zip(table.docs, table.tfs)):
        cold_tier.cold_tier_plain(loop, terms.tier, terms.row, terms.q_w, t,
                                  tdocs, ttfs, dl_norm=dl_norm, k1=k1)
    assert torch.equal(got.view(torch.int32), loop.view(torch.int32))


def _stage_reference(start, q_tier, rows, q_w, tiers, dl_norm, k1, *,
                     l_first=False):
    """numpy float32 sum of the cold stage, one rounded multiply and one
    rounded add a cell, in (tier, l) order (or (l, tier) with `l_first`),
    over cells from the port's weight functions."""
    out = start.numpy().copy()
    q_tier, rows, q_w = q_tier.numpy(), rows.numpy(), q_w.numpy()
    width = out.shape[1]
    cells = []
    for tdocs, ttfs in zip(tiers.docs, tiers.tfs):
        dl = None if dl_norm is None else dl_norm[tdocs.clamp(0, width - 1)]
        cells.append((scoring._lntf(ttfs) if dl is None else
                      scoring.bm25_saturation(ttfs, dl, k1=k1)).numpy())
    pairs = [(t, l) for t in range(len(tiers)) for l in range(q_w.shape[1])]
    if l_first:
        pairs.sort(key=lambda p: (p[1], p[0]))
    for t, l in pairs:
        docs, tfs = tiers.docs[t].numpy(), tiers.tfs[t].numpy()
        if docs.size == 0:
            continue
        for b in np.nonzero((q_tier[:, l] == t) & (q_w[:, l] != 0))[0]:
            r = min(max(int(rows[b, l]), 0), len(docs) - 1)
            keep = (tfs[r] > 0) & (docs[r] >= 0) & (docs[r] < width)
            d = docs[r, keep]                 # distinct within a row
            out[b, d] = out[b, d] + cells[t][r, keep] * q_w[b, l]
    return out


@pytest.mark.parametrize("bm25", [False, True])
@pytest.mark.parametrize("terms", [1, 2, 3, 9])
def test_twin_at_the_card_edge_cases(terms, bm25):
    """At chip_smoke's cold-tier edge cases (the cases the card holds the
    kernel against the twin at), the CPU wrapper (the twin) equals a numpy
    float32 sum in (tier, l) order, bitwise; query 0's shared doc shows
    that the order decides the bits."""
    order_matters = 0
    cases = [dict(batch=b) for b in (1, 37)]
    cases += [dict(batch=5, caps=c) for c in chip_smoke.COLD_EDGE_ORDERS]
    cases += [dict(batch=5, caps=()),
              dict(batch=5, caps=tuple(range(1, cold_tier.MAX_TIERS + 1)))]
    for i, case in enumerate(cases):
        start, q_tier, rows, q_w, tiers, dl_norm = chip_smoke.cold_edge_case(
            100 * terms + i, terms=terms, device="cpu", **case)
        kw = {"dl_norm": dl_norm, "k1": 0.9} if bm25 else {}
        got = start.clone()
        cold_tier.cold_stage(got, q_tier, rows, q_w, tiers, **kw)
        want = _stage_reference(start, q_tier, rows, q_w, tiers,
                                kw.get("dl_norm"), 0.9)
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))
        assert len(tiers) == 0 or not torch.equal(got, start)
        if terms >= 3 and len(tiers) == len(chip_smoke.COLD_EDGE_CAPS):
            other = _stage_reference(start, q_tier, rows, q_w, tiers,
                                     kw.get("dl_norm"), 0.9, l_first=True)
            order_matters += int(other[0].view(np.int32)[
                chip_smoke.COLD_SHARED_DOC] != want[0].view(np.int32)[
                chip_smoke.COLD_SHARED_DOC])
    if terms >= 3:
        assert order_matters >= 1
