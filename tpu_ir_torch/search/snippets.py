"""Query-highlighted text snippets from the document store: the port's
copy of `tpu_ir/search/snippets.py`.

With `index --store` the raw document text survives next to the index
(index/docstore.py); `search --snippets` renders, for each hit, a window
of the original text centred on the densest cluster of query-term
matches, with the matching words wrapped in ``**``.

A display word matches when its analyzed form (tag tokenizer, stopwords,
Porter2) hits a query token, so "Fishing," highlights for the query
"fish" exactly when the index matched it, and never on a raw substring.
"""

from __future__ import annotations

import re

_TAG_RE = re.compile(r"<[^>\n]{0,256}>")
_WS_RE = re.compile(r"\s+")
# metadata elements whose CONTENT is not document text: the docid (the
# caller already printed it) and trecweb's HTTP header block
_META_RE = re.compile(r"<(DOCNO|DOCHDR)>.*?</\1>", re.S | re.I)

SNIPPET_WORDS = 16   # window width in display words
MARK = "**"
# rendering work is bounded: at most this much raw record text is ever
# considered for a snippet (a multi-MB document must not make every
# query that hits it crawl through the analyzer word by word)
SNIPPET_SCAN_BYTES = 1 << 20
# the first this-many display words are scanned EXACTLY (densest-cluster
# selection, identical to an unbounded scan); past it the scan may stop
# at a window that already covers every distinct query token
SNIPPET_EXACT_WORDS = 4096


def display_text(content: str) -> str:
    """Raw stored record -> displayable text: metadata elements removed
    wholesale, remaining tags dropped, whitespace collapsed."""
    return _WS_RE.sub(
        " ", _TAG_RE.sub(" ", _META_RE.sub(" ", content))).strip()


def make_snippet(content: str, query_tokens: set[str], analyzer,
                 width: int = SNIPPET_WORDS,
                 scan_bytes: int = SNIPPET_SCAN_BYTES,
                 exact_words: int = SNIPPET_EXACT_WORDS) -> str:
    """One highlighted window. `query_tokens` are ANALYZED query tokens
    (token-level, not k-grams — phrase/k-gram queries highlight their
    component words).

    Work is bounded without changing results for
    normal documents: documents shorter than `exact_words` display words
    get the full densest-cluster selection (identical to an unbounded
    scan). Past `exact_words`, the scan stops as soon as some window has
    covered every distinct query token; the shown window is then the
    full-coverage one, unless a strictly denser cluster was already seen
    (the unbounded scan's choice for the scanned region). `scan_bytes`
    caps the raw text considered at all when the query never fully
    co-occurs."""
    truncated = len(content) > scan_bytes
    if truncated:
        # cut at whitespace: a mid-word (or mid-tag) slice would leak a
        # partial token like '</TEX' past the tag-stripping regexes
        cut = content[:scan_bytes]
        ws = max(cut.rfind(" "), cut.rfind("\n"), cut.rfind("\t"))
        content = cut[:ws] if ws > 0 else cut
    words = display_text(content).split(" ")
    if not words:
        return ""
    # memoize per call: documents repeat words heavily, and the analyzer
    # (tokenize + stopwords + Porter2) is the scan's whole cost
    memo: dict[str, frozenset] = {}

    def matched_tokens(w: str) -> frozenset:
        hit = memo.get(w)
        if hit is None:
            hit = memo[w] = frozenset(
                t for t in analyzer.analyze(w) if t in query_tokens)
        return hit

    # one forward scan with a sliding window over the hit positions:
    # densest cluster so far, plus the best FULL-coverage window (every
    # distinct query token inside) for the bounded early exit
    hits: list[int] = []
    hit_toks: list[frozenset] = []
    best_lo, best_n = 0, 0
    full: tuple[int, int] | None = None
    j = 0
    window_count: dict[str, int] = {}
    for i, w in enumerate(words):
        toks = matched_tokens(w)
        if toks:
            hits.append(i)
            hit_toks.append(toks)
            for t in toks:
                window_count[t] = window_count.get(t, 0) + 1
            while hits[j] < i - width + 1:
                for t in hit_toks[j]:
                    window_count[t] -= 1
                    if not window_count[t]:
                        del window_count[t]
                j += 1
            if len(hits) - j > best_n:
                best_n, best_lo = len(hits) - j, hits[j]
            if (len(window_count) == len(query_tokens)
                    and (full is None or len(hits) - j > full[1])):
                full = (hits[j], len(hits) - j)
        if i >= exact_words and full is not None:
            # bounded region: stop scanning — a window already shows the
            # whole query. Show it unless the exact region found a
            # strictly DENSER cluster (what an unbounded scan of that
            # region would have picked)
            if full[1] >= best_n:
                best_lo, best_n = full
            break

    if not hits:
        head = " ".join(words[:width])
        return head + (" ..." if len(words) > width or truncated else "")
    # center the cluster; a cluster spanning the full window gets shift 0
    # (a forced shift of 1 would cut its last matched word off)
    lo = max(0, best_lo - max((width - best_n) // 2, 0))
    hi = min(len(words), lo + width)
    hit_set = set(hits)
    # words past an early-exit position were never analyzed; they can
    # appear unhighlighted at the window's tail — the bounded-work
    # contract trades that for not scanning multi-MB docs to the end
    out = [(MARK + w + MARK) if i in hit_set else w
           for i, w in enumerate(words[lo:hi], lo)]
    return (("... " if lo > 0 else "") + " ".join(out)
            + (" ..." if hi < len(words) or truncated else ""))
