"""The port's TREC text/web stream parsers and the corpus tools (`pack`,
`count`, `docno`) against the JAX package's: the parsed Document fields
are equal, and each command's standard output and written files are equal
byte for byte. Host only; nothing here touches a device."""

import os

import pytest

from tpu_ir import cli as jax_cli
from tpu_ir.collection import parsers as jax_parsers

from tpu_ir_torch import cli
from tpu_ir_torch.collection import (
    Document,
    TrecTextParser,
    TrecWebParser,
    parse_document,
    to_trec,
)
from tpu_ir_torch.index import build_index

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CORPUS = os.path.join(ROOT, "data", "stdlib", "corpus.trec")

TRECTEXT = """\
junk preamble
<DOC>
<DOCNO> AP-900101-0001 </DOCNO>
<FILEID>AP-NR-01-01-90</FILEID>
<HEAD>
Fish Stocks Rebound
</HEAD>
<IGNORED>not indexed</IGNORED>
<TEXT>
Salmon runs returned to the river.
Second line.
</TEXT>
</DOC>
<DOC>
<DOCNO>
 AP-2 </DOCNO>
<TEXT>one-line section</TEXT>
<JUNK>should be dropped</JUNK>
<HL>headline &amp; more</HL>
</DOC>
<DOC>
<DOCNO> AP-3 </DOCNO>\r
<LP>\r
crlf lead paragraph\r
</LP>\r
</DOC>
"""

TRECWEB = """\
<DOC>
<DOCNO> WT01-B01-1 </DOCNO>
<DOCHDR>
HTTP://Example.COM:80/Path/# 199.0.0.1 19970101
Content-type: text/html
</DOCHDR>
<html><head><title>Example Page</title></head>
<body>web content here</body></html>
</DOC>
<DOC>
<DOCNO> WT01-B01-2</DOCNO>
<DOCHDR>
http://host.org:80
</DOCHDR>
<p>second <b>page</b></p>
</DOC>
"""

LINES = "first line of text\n\nthird: Fishing, salmon!\nünïcode line\n"


def fields(d):
    return (d.identifier, d.text, d.metadata,
            d.terms, [(t.name, t.attributes, t.begin, t.end) for t in d.tags])


@pytest.mark.parametrize("fmt_name,text", [("trectext", TRECTEXT),
                                           ("trecweb", TRECWEB)])
def test_parsed_documents_equal_jax(fmt_name, text):
    """Every Document field, after parse_document, equals the JAX
    package's, and so does its canonical TREC record."""
    ours = (TrecTextParser if fmt_name == "trectext" else TrecWebParser)
    theirs = (jax_parsers.TrecTextParser if fmt_name == "trectext"
              else jax_parsers.TrecWebParser)
    got = [parse_document(d) for d in ours(text)]
    want = [jax_parsers.parse_document(d) for d in theirs(text)]
    assert len(got) == len(want) >= 2
    assert [fields(g) for g in got] == [fields(w) for w in want]
    assert [to_trec(g) for g in got] == [jax_parsers.to_trec(w)
                                         for w in want]


@pytest.mark.parametrize("url", ["HTTP://A.b:80/x/#", "http://h:80",
                                 "http://h:8080/p//", "http://h/#"])
def test_scrub_url_equal_jax(url):
    assert TrecWebParser.scrub_url(url) == \
        jax_parsers.TrecWebParser.scrub_url(url)
    d = parse_document(Document("X", "<b>Big</b> words"), record_tags=False)
    assert d.terms == ["big", "words"] and d.tags == []


def run_both(capsys, argv_port, argv_jax):
    rc = cli.main(argv_port)
    got = capsys.readouterr()
    rc_jax = jax_cli.main(argv_jax)
    want = capsys.readouterr()
    return (rc, got.out, got.err), (rc_jax, want.out, want.err)


@pytest.mark.parametrize("fmt_name", ["lines", "trectext", "trecweb"])
def test_pack_output_equal_jax(tmp_path, capsys, fmt_name):
    src = tmp_path / "in.txt"
    src.write_text({"lines": LINES, "trectext": TRECTEXT,
                    "trecweb": TRECWEB}[fmt_name], encoding="utf-8")
    got_f, want_f = str(tmp_path / "got.trec"), str(tmp_path / "want.trec")
    extra = ["--format", fmt_name, "--prefix", "TXT"]
    got, want = run_both(capsys, ["pack", str(src), got_f] + extra,
                         ["pack", str(src), want_f] + extra)
    assert got[0] == want[0] == 0
    assert got[1] == want[1].replace("want.trec", "got.trec")
    assert open(got_f, "rb").read() == open(want_f, "rb").read()


def test_count_output_equal_jax(tmp_path, capsys):
    packed = str(tmp_path / "packed.trec")
    with open(packed, "w") as f:
        for d in TrecWebParser(TRECWEB):
            f.write(to_trec(d))
    for corpus in ([CORPUS], [CORPUS, packed], [str(tmp_path)]):
        got, want = run_both(capsys, ["count"] + corpus, ["count"] + corpus)
        assert got == want
        assert '"Count.DOCS"' in got[1]


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("docno") / "idx")
    build_index(CORPUS, d, num_shards=2, compute_chargrams=False,
                device="cpu")
    return d


@pytest.mark.parametrize("args", [
    ["list"], ["getDocno", "PY-heapq"], ["getDocid", "7"],
    ["getDocno", "nope"], ["getDocid", "0"], ["getDocid", "x"],
    ["getDocid"]])
def test_docno_output_equal_jax(capsys, index_dir, args):
    got, want = run_both(capsys, ["docno", index_dir] + args,
                         ["docno", index_dir] + args)
    assert got == want
    if args == ["list"]:
        assert len(got[1].splitlines()) == 144
