"""The fused dense-score kernels' plain twins (what the wrappers run on a
CPU tensor) against the JAX package's Pallas kernels, run here in
interpret mode, and against its XLA dense path: `dense_scores` over the
float32 (1 + ln tf) matrix against `pallas_tfidf_scores`, and
`dense_scores_quantized` over a bf16 raw-tf matrix against
`pallas_tfidf_scores_quantized`. The quantized twin is also held bitwise
against the float32 one on the same tfs.

Tolerance: rtol 1e-5, atol 1e-6. XLA and torch may sum in another order
and round log10 and ln differently in the last place; the kernel itself is
held bitwise against the twin on the card (chip_smoke.py and
tests/test_torch_cuda.py)."""

import ctypes
import os
import re
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
# Both kernels run in one child: "s<seed>" are pallas_tfidf_scores's
# scores, "u<seed>" pallas_tfidf_scores_quantized's over the bf16 raw tfs.
_PALLAS_CHILD = """
import sys
import jax.numpy as jnp, numpy as np
from tpu_ir.ops.pallas_scoring import (pallas_tfidf_scores,
                                       pallas_tfidf_scores_quantized)
z = np.load(sys.argv[1])
df, n = jnp.asarray(z["df"]), jnp.int32(int(z["n"]))
tf16 = jnp.asarray(z["tf"]).astype(jnp.bfloat16)
out = {}
for key in z.files:
    if key.startswith("q"):
        q = jnp.asarray(z[key])
        out["s" + key[1:]] = np.asarray(pallas_tfidf_scores(
            q, jnp.asarray(z["matrix"]), df, n, interpret=True))
        out["u" + key[1:]] = np.asarray(pallas_tfidf_scores_quantized(
            q, tf16, df, n, interpret=True))
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
def tf_matrices(index_data):
    """The raw-tf matrices: the JAX package's float32 one, and the port's
    bf16 one (the dense layout of a compressed index)."""
    cols, _, _, _ = index_data
    jtf = jscoring.dense_tf_matrix(*(jnp.asarray(c) for c in cols),
                                   vocab_size=VOCAB, num_docs=NDOCS)
    ttf = scoring.dense_tf_matrix(*(torch.from_numpy(c) for c in cols),
                                  vocab_size=VOCAB, num_docs=NDOCS,
                                  dtype=torch.bfloat16)
    return np.asarray(jtf), ttf


@pytest.fixture(scope="module")
def pallas_outputs(index_data, tf_matrices, tmp_path_factory):
    """Both Pallas kernels' scores from one interpreted child run."""
    _, df, jmat, _ = index_data
    d = tmp_path_factory.mktemp("pallas")
    np.savez(d / "in.npz", matrix=np.asarray(jmat), tf=tf_matrices[0],
             df=df, n=NDOCS, **{f"q{s}": _queries(s) for s in PALLAS_SEEDS})
    r = subprocess.run([sys.executable, "-c", _PALLAS_CHILD,
                        str(d / "in.npz"), str(d / "out.npz")],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(d / "out.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def pallas_scores(pallas_outputs):
    """{seed: pallas_tfidf_scores scores}."""
    return {s: pallas_outputs[f"s{s}"] for s in PALLAS_SEEDS}


@pytest.mark.parametrize("seed", PALLAS_SEEDS)
def test_twin_matches_pallas_interpret(index_data, pallas_scores, seed):
    _, df, _, tmat = index_data
    got = fused_scoring.tfidf_scores(torch.from_numpy(_queries(seed)), tmat,
                                     torch.from_numpy(df), NDOCS)
    np.testing.assert_allclose(got.numpy(), pallas_scores[seed], rtol=RTOL,
                               atol=ATOL)
    assert (got[7] == 0).all()


def test_bf16_tf_matrix_matches_jax(tf_matrices):
    jtf, ttf = tf_matrices
    assert ttf.dtype == torch.bfloat16 and ttf.is_contiguous()
    want = jnp.asarray(jtf).astype(jnp.bfloat16).astype(jnp.float32)
    assert np.array_equal(ttf.float().numpy(), np.asarray(want))
    assert np.array_equal(ttf.float().numpy(), jtf)     # tfs are bf16-exact


@pytest.mark.parametrize("seed", PALLAS_SEEDS)
def test_quantized_twin_matches_pallas_interpret(index_data, tf_matrices,
                                                 pallas_outputs, seed):
    _, df, _, _ = index_data
    got = fused_scoring.tfidf_scores_quantized(
        torch.from_numpy(_queries(seed)), tf_matrices[1],
        torch.from_numpy(df), NDOCS)
    assert got.dtype == torch.float32 and got.shape == (16, NDOCS + 1)
    np.testing.assert_allclose(got.numpy(), pallas_outputs[f"u{seed}"],
                               rtol=RTOL, atol=ATOL)
    assert (got[7] == 0).all()


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("seed", [6, 14])
def test_quantized_twin_equals_float32_twin_bitwise(index_data, tf_matrices,
                                                    seed, compat):
    """On bf16-exact tfs the quantized twin gives the float32 twin's bits
    (the compressed == raw contract of the dense layout)."""
    _, df, _, tmat = index_data
    q = torch.from_numpy(_queries(seed, b=32, l=4))
    idf = scoring.idf_weights(torch.from_numpy(df), NDOCS, compat)
    got = fused_scoring.dense_scores_quantized(q, idf, tf_matrices[1])
    want = fused_scoring.dense_scores(q, idf, tmat)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    gs, gd = scoring.tfidf_topk_dense_quantized(
        q, tf_matrices[1], torch.from_numpy(df), NDOCS, k=10,
        compat_int_idf=compat)
    ws, wd = scoring.tfidf_topk_dense(q, tmat, torch.from_numpy(df), NDOCS,
                                      k=10, compat_int_idf=compat)
    assert torch.equal(gd, wd) and torch.equal(gs, ws)


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
    tf16 = tmat.to(torch.bfloat16)
    assert torch.equal(fused_scoring.dense_scores_quantized(q, idf, tf16),
                       fused_scoring.dense_scores_quantized_plain(q, idf,
                                                                  tf16))
    assert tpu_ir_torch.kernel_launches() == {"dense_score": 0,
                                              "dequant_score": 0,
                                              "cold_tier": 0,
                                              "hot_stage": 0}
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


@pytest.mark.parametrize("bad", ["float32_matrix", "dtype_ids", "dtype_w",
                                 "shape", "contiguous", "matrix_rank"])
def test_quantized_wrapper_rejects_bad_inputs(index_data, tf_matrices, bad):
    _, df, _, tmat = index_data
    ttf = tf_matrices[1]
    q = torch.from_numpy(_queries(13))
    idf = scoring.idf_weights(torch.from_numpy(df), NDOCS)
    args = {"float32_matrix": (q, idf, tmat),
            "dtype_ids": (q.float(), idf, ttf),
            "dtype_w": (q, idf.double(), ttf),
            "shape": (q, idf[:-1], ttf),
            "contiguous": (q, idf, ttf.t().contiguous().t()),
            "matrix_rank": (q, idf, ttf.reshape(-1))}[bad]
    with pytest.raises(ValueError, match="dense_scores_quantized"):
        fused_scoring.dense_scores_quantized(*args)
    with pytest.raises(ValueError):
        fused_scoring.dense_scores_quantized_plain(*args)


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


# What the CPU can check of the CUDA kernels: their sources keep the
# bitwise rules, each C entry point's parameters match the ctypes types its
# wrapper sets, and the wrappers' CPU path (the plain twins the kernels are
# held against) is right at the card tests' edge shapes.

CSRC = os.path.join(ROOT, "tpu_ir_torch", "csrc")
DENSE_SOURCES = ["dense_rows.cuh", "dense_score.cu", "dequant_score.cu"]


def _source(name):
    with open(os.path.join(CSRC, name), encoding="utf-8") as f:
        return f.read()


def _code(src):
    """A CUDA source without its comments."""
    return re.sub(r"//[^\n]*|/\*.*?\*/", "", src, flags=re.S)


@pytest.mark.parametrize("name", DENSE_SOURCES + ["cold_tier.cu",
                                                  "hot_stage.cu"])
def test_dense_kernel_sources_keep_the_bitwise_rules(name):
    code = _code(_source(name))
    for banned in ("fmaf", "__fma", "__logf", "__fdividef", "__expf",
                   "__powf", "atomic"):
        assert banned not in code, f"{name} uses {banned}"
    if name == "cold_tier.cu":
        from tpu_ir_torch.ops import cold_tier

        # each posting: one rounded multiply, then one rounded add, onto
        # the score read before; BM25 divides rounded; TF-IDF's ln is logf
        assert re.search(r"__fadd_rn\(\s*s\[j\],\s*__fmul_rn\(cell, w\)\)",
                         code)
        assert "__fdiv_rn(" in code and "logf(tff)" in code
        # the profiler filter finds the kernel by this name
        assert re.search(r"\bcold_tier_kernel\(", code)
        assert int(re.search(r"kMaxTiers = (\d+);", code).group(1)) == \
            cold_tier.MAX_TIERS
    elif name == "hot_stage.cu":
        # each live slot: one rounded multiply, then one rounded add, in
        # slot order; then one rounded add onto the score
        assert re.search(r"__fadd_rn\(\s*acc\[j\],\s*__fmul_rn\(v\[j\],"
                         r"\s*w\)\)", code)
        assert re.search(r"sb\[c\] = __fadd_rn\(sb\[c\], acc\[j\]\)", code)
        assert re.search(r"\bhot_stage_kernel\(", code)
    elif name != "dense_rows.cuh":
        assert '#include "dense_rows.cuh"' in code
    else:         # each term: one rounded multiply, then one rounded add
        assert re.search(r"__fadd_rn\(\s*acc\[j\],\s*__fmul_rn\(", code)
    if name == "dequant_score.cu":
        assert "logf(" in code


def test_nvcc_flags_have_no_fast_math():
    from tpu_ir_torch.ops import _build

    flags = " ".join(_build.NVCC_FLAGS)
    for banned in ("fast_math", "fast-math", "ftz=true", "prec-div=false",
                   "prec-sqrt=false"):
        assert banned not in flags
    assert "arch=compute_90a,code=sm_90a" in flags


def _c_params(src, symbol):
    """The ctypes kind of each parameter of `extern "C" int symbol(...)`."""
    m = re.search(r'extern\s+"C"\s+int\s+' + symbol + r"\s*\(([^)]*)\)",
                  _code(src))
    assert m, symbol
    kinds = []
    for param in m.group(1).split(","):
        words = param.replace("*", " * ").split()
        if "*" in words:
            kinds.append(ctypes.c_void_p)
        else:
            kinds.append({"int64_t": ctypes.c_int64,
                          "int32_t": ctypes.c_int32, "int": ctypes.c_int,
                          "float": ctypes.c_float}[words[-2]])
    return kinds


@pytest.mark.parametrize("name", ["dense_score", "dequant_score",
                                  "cold_tier", "hot_stage"])
def test_c_entry_parameters_match_ctypes_argtypes(name):
    from tpu_ir_torch.ops import cold_tier, hot_stage

    argtypes = {"cold_tier": cold_tier.ARGTYPES,
                "hot_stage": hot_stage.ARGTYPES}.get(name,
                                                     fused_scoring.ARGTYPES)
    assert _c_params(_source(f"{name}.cu"), f"tpu_ir_{name}") == argtypes


EDGE_WIDTHS = [1, 2, 3, 5] + list(range(8_761, 8_770))


def _edge_case(seed, width, batch, terms, vocab=50):
    """The card tests' edge inputs (tests/test_torch_cuda.py), on the CPU:
    ids V-1, -1 pads, an empty query and ids past V; idf zeros; integer
    tfs as bf16 and their float32 (1 + ln tf) matrix."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-1, vocab + 2, (batch, terms))
    q[::3, 0] = vocab - 1
    if terms > 1:
        q[1::2, 1] = vocab + 5
    if batch > 1:
        q[1] = -1
    idf = rng.uniform(0.05, 3.0, vocab).astype(np.float32)
    idf[rng.random(vocab) < 0.2] = 0.0
    tf = rng.integers(1, 257, (vocab, width))
    tf[rng.random((vocab, width)) < 0.7] = 0
    tf16 = torch.from_numpy(tf).to(torch.bfloat16)
    return q, idf, tf16, scoring._lntf(tf16)


@pytest.mark.parametrize("terms", [1, 2, 3, 9])
@pytest.mark.parametrize("width", EDGE_WIDTHS)
def test_cpu_wrappers_at_the_card_edge_shapes(width, terms):
    """At every shape the card tests hold the kernels against the twins,
    the CPU wrappers (the twins) equal a numpy float32 sum in l order,
    each term one rounded multiply and one rounded add; the quantized
    twin equals the float32 one bitwise; an int64 batch with ids past
    int32 gives what -1 pads give."""
    for batch in (1, 37):
        q, idf, tf16, matrix = _edge_case(width * 10 + terms + batch, width,
                                          batch, terms)
        vocab = idf.shape[0]
        valid = (q >= 0) & (q < vocab)
        w = np.where(valid, idf[np.where(valid, q, 0)], np.float32(0))
        rows = matrix.numpy()[np.where(valid, q, 0)]       # [B, L, D+1]
        want = np.zeros((batch, width), np.float32)
        for l in range(terms):
            want = want + rows[:, l] * w[:, l, None]
        q32 = torch.from_numpy(q.astype(np.int32))
        idf_t = torch.from_numpy(idf)
        got = fused_scoring.dense_scores(q32, idf_t, matrix)
        assert got.dtype == torch.float32 and got.shape == (batch, width)
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))
        got2 = fused_scoring.dense_scores_quantized(q32, idf_t, tf16)
        assert torch.equal(got2.view(torch.int32), got.view(torch.int32))
        if batch > 1:
            assert bool((got[1] == 0).all())             # the empty query
        q64 = torch.from_numpy(q.astype(np.int64))
        q64[0, 0] = 2 ** 32 + 3            # an int32 cast alone would make 3
        q32[0, 0] = -1
        assert torch.equal(
            fused_scoring.dense_scores(q64, idf_t, matrix).view(torch.int32),
            fused_scoring.dense_scores(q32, idf_t, matrix).view(torch.int32))
