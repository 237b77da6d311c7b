"""The fused dense-score kernel's plain twin (what the wrapper runs on a
CPU tensor) against the JAX package's Pallas kernel, run here in
interpret mode, and against its XLA dense path.

Tolerance: rtol 1e-5, atol 1e-6. XLA and torch may sum in another order
and round log10 and ln differently in the last place; the kernel itself is
held bitwise against the twin on the card (chip_smoke.py and
tests/test_torch_cuda.py)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ir.ops import PAD_TERM, build_postings_jit
from tpu_ir.ops import scoring as jscoring

import tpu_ir_torch
from tpu_ir_torch.ops import fused_scoring, scoring

RTOL, ATOL = 1e-5, 1e-6
VOCAB, NDOCS = 128, 127
PALLAS_SEEDS = [6, 7, 8]
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

# The Pallas kernel, interpreted on the CPU, runs in a child interpreter:
# this suite's conftest keeps only JAX's CPU backend, and without the TPU
# platform registered the Pallas import itself fails here (the reason
# tests/test_pallas.py skips in this suite).
_PALLAS_CHILD = """
import sys
import jax.numpy as jnp, numpy as np
from tpu_ir.ops.pallas_scoring import pallas_tfidf_scores
z = np.load(sys.argv[1])
out = {}
for key in z.files:
    if key.startswith("q"):
        out["s" + key[1:]] = np.asarray(pallas_tfidf_scores(
            jnp.asarray(z[key]), jnp.asarray(z["matrix"]),
            jnp.asarray(z["df"]), jnp.int32(int(z["n"])), interpret=True))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def index_data():
    """Postings columns (numpy) and both packages' doc matrices."""
    rng = np.random.default_rng(5)
    n_tok = 3000
    term_ids = np.full(4096, PAD_TERM, np.int32)
    doc_ids = np.zeros(4096, np.int32)
    term_ids[:n_tok] = rng.integers(0, VOCAB - 8, n_tok)  # 8 df == 0 terms
    doc_ids[:n_tok] = rng.integers(1, NDOCS + 1, n_tok)
    p = build_postings_jit(jnp.asarray(term_ids), jnp.asarray(doc_ids),
                           vocab_size=VOCAB, num_docs=NDOCS)
    n = int(p.num_pairs)
    cols = tuple(np.array(a)[:n] for a in (p.pair_term, p.pair_doc,
                                            p.pair_tf))
    jmat = jscoring.dense_doc_matrix(*(jnp.asarray(c) for c in cols),
                                     vocab_size=VOCAB, num_docs=NDOCS)
    tmat = scoring.dense_doc_matrix(*(torch.from_numpy(c) for c in cols),
                                    vocab_size=VOCAB, num_docs=NDOCS)
    return cols, np.array(p.df), jmat, tmat


def _queries(seed, b=16, l=3):
    q = np.random.default_rng(seed).integers(0, VOCAB, (b, l)).astype(
        np.int32)
    q[3, 1] = -1                      # padding
    q[7, :] = -1                      # an empty query
    q[8, :] = q[8, 0]                 # a duplicated term
    q[9, 2] = VOCAB + 11              # out of vocabulary
    q[10, 0] = VOCAB - 1              # a df == 0 term
    return q


def test_dense_matrices_match(index_data):
    cols, _, jmat, tmat = index_data
    np.testing.assert_allclose(tmat.numpy(), np.asarray(jmat), rtol=1e-6,
                               atol=0)
    jtf = jscoring.dense_tf_matrix(*(jnp.asarray(c) for c in cols),
                                   vocab_size=VOCAB, num_docs=NDOCS)
    ttf = scoring.dense_tf_matrix(*(torch.from_numpy(c) for c in cols),
                                  vocab_size=VOCAB, num_docs=NDOCS)
    np.testing.assert_array_equal(ttf.numpy(), np.asarray(jtf))


@pytest.fixture(scope="module")
def pallas_scores(index_data, tmp_path_factory):
    """{seed: Pallas kernel scores} from one interpreted child run."""
    _, df, jmat, _ = index_data
    d = tmp_path_factory.mktemp("pallas")
    np.savez(d / "in.npz", matrix=np.asarray(jmat), df=df, n=NDOCS,
             **{f"q{s}": _queries(s) for s in PALLAS_SEEDS})
    r = subprocess.run([sys.executable, "-c", _PALLAS_CHILD,
                        str(d / "in.npz"), str(d / "out.npz")],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(d / "out.npz") as z:
        return {s: z[f"s{s}"] for s in PALLAS_SEEDS}


@pytest.mark.parametrize("seed", PALLAS_SEEDS)
def test_twin_matches_pallas_interpret(index_data, pallas_scores, seed):
    _, df, _, tmat = index_data
    got = fused_scoring.tfidf_scores(torch.from_numpy(_queries(seed)), tmat,
                                     torch.from_numpy(df), NDOCS)
    np.testing.assert_allclose(got.numpy(), pallas_scores[seed], rtol=RTOL,
                               atol=ATOL)
    assert (got[7] == 0).all()


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("seed", [6, 9])
def test_twin_matches_xla_dense(index_data, seed, compat):
    _, df, jmat, tmat = index_data
    q = _queries(seed, b=32, l=4)
    want = jscoring._tfidf_dense_scores(jnp.asarray(q), jmat,
                                        jnp.asarray(df), jnp.int32(NDOCS),
                                        compat)
    got = fused_scoring.tfidf_scores(torch.from_numpy(q), tmat,
                                     torch.from_numpy(df), NDOCS,
                                     compat_int_idf=compat)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("compat", [False, True])
def test_idf_weights_match(index_data, compat):
    _, df, _, _ = index_data
    want = jscoring.idf_weights(jnp.asarray(df), NDOCS, compat)
    got = scoring.idf_weights(torch.from_numpy(df), NDOCS, compat)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_bm25_weights_match(index_data):
    _, df, _, _ = index_data
    want = jscoring.bm25_idf_weights(jnp.asarray(df), jnp.int32(NDOCS))
    got = scoring.bm25_idf_weights(torch.from_numpy(df), NDOCS)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    tf = np.array([0, 0, 1, 3, 7], np.float32)
    dl = np.array([0, 1, 0.5, 1.2, 0], np.float32)
    np.testing.assert_allclose(
        scoring.bm25_saturation(torch.from_numpy(tf), torch.from_numpy(dl),
                                k1=0.9).numpy(),
        np.asarray(jscoring.bm25_saturation(jnp.asarray(tf),
                                            jnp.asarray(dl), k1=0.9)),
        rtol=RTOL, atol=ATOL)


def test_bm25_dense_scores_match(index_data):
    cols, df, _, _ = index_data
    rng = np.random.default_rng(3)
    doc_len = rng.integers(0, 50, NDOCS + 1).astype(np.int32)
    jtf = jscoring.dense_tf_matrix(*(jnp.asarray(c) for c in cols),
                                   vocab_size=VOCAB, num_docs=NDOCS)
    ttf = scoring.dense_tf_matrix(*(torch.from_numpy(c) for c in cols),
                                  vocab_size=VOCAB, num_docs=NDOCS)
    q = _queries(11)
    want = jscoring._bm25_dense_scores(jnp.asarray(q), jtf, jnp.asarray(df),
                                       jnp.asarray(doc_len),
                                       jnp.int32(NDOCS), 0.9, 0.4)
    got = scoring._bm25_dense_scores(torch.from_numpy(q), ttf,
                                     torch.from_numpy(df),
                                     torch.from_numpy(doc_len), NDOCS,
                                     0.9, 0.4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_cpu_wrapper_runs_the_twin_without_counting(index_data):
    _, df, _, tmat = index_data
    q = torch.from_numpy(_queries(12))
    idf = scoring.idf_weights(torch.from_numpy(df), NDOCS)
    tpu_ir_torch.reset_kernel_launches()
    got = fused_scoring.dense_scores(q, idf, tmat)
    want = fused_scoring.dense_scores_plain(q, idf, tmat)
    assert torch.equal(got, want)
    assert tpu_ir_torch.kernel_launches() == {"dense_score": 0}
    safe_q, q_w = fused_scoring.query_weights(q, idf)
    assert int(safe_q.min()) >= 0 and int(safe_q.max()) < VOCAB
    assert float(q_w[7].abs().sum()) == 0.0     # empty query weighs 0
    assert float(q_w[9, 2]) == 0.0              # out-of-vocabulary id


@pytest.mark.parametrize("bad", ["dtype_ids", "dtype_w", "shape",
                                 "contiguous", "matrix_rank"])
def test_wrapper_rejects_bad_inputs(index_data, bad):
    _, df, _, tmat = index_data
    q = torch.from_numpy(_queries(13))
    idf = scoring.idf_weights(torch.from_numpy(df), NDOCS)
    args = {"dtype_ids": (q.float(), idf, tmat),
            "dtype_w": (q, idf.double(), tmat),
            "shape": (q, idf[:-1], tmat),
            "contiguous": (q, idf, tmat.t().contiguous().t()),
            "matrix_rank": (q, idf, tmat.reshape(-1))}[bad]
    with pytest.raises(ValueError):
        fused_scoring.dense_scores(*args)


def test_cuda_default_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpu_ir_torch.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpu_ir_torch.resolve_device("cuda")
    from tpu_ir_torch.index import build_index
    from tpu_ir_torch.search import Scorer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_index([str(tmp_path / "none.trec")], str(tmp_path / "idx"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Scorer.load(str(tmp_path / "idx"))
    assert tpu_ir_torch.resolve_device("cpu").type == "cpu"


_FIRST_CALL = """
import sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from tpu_ir_torch.ops import scoring
lntf = scoring._lntf(torch.full((262_656,), 3, dtype=torch.int32))
idf = scoring.idf_weights(torch.full((262_656,), 37, dtype=torch.int32), 300)
want_lntf = np.float32(1) + np.log(np.float32(3))
want_idf = np.log10(np.float32(300) / np.float32(37))
print(int((lntf.numpy() != want_lntf).sum()), int((idf.numpy() != want_idf).sum()))
"""


def test_first_cpu_log_of_a_process_is_exact():
    """A process's first multi-threaded CPU log must be as exact as later
    ones (see scoring._ready_cpu_math); several fresh processes, since a
    bad first call shows only in some of them."""
    procs = [subprocess.Popen([sys.executable, "-c", _FIRST_CALL, ROOT],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.split() == ["0", "0"], out
