"""HTML/XML-tag-aware tokenizer.

Behavior-parity target: the Galago TagTokenizer vendored by the reference
(org/galagosearch/core/parse/TagTokenizer.java). Semantics reproduced:

- Split characters: all ASCII codepoints <= 32 plus
  ``; " & / : ! # ? $ % ( ) @ ^ * + - , = > < [ ] { } | ` ~ _``
  (TagTokenizer.java:73-95). Period and apostrophe are NOT split chars.
- ``<`` opens tag handling: ``</`` end tag, ``<!`` comment, ``<?`` processing
  instruction, otherwise begin tag (:602-620). ``<style>``/``<script>``
  content is ignored until the matching end tag (:97-102, :388-390).
- ``&`` starts an XML-entity skip when followed by ``[a-z0-9#]* ;`` (:644-662).
- Token post-processing (:573-600): tokens of only ``[a-z0-9]`` pass through;
  uppercase/apostrophes trigger a simple fix (ASCII lowercase + apostrophe
  removal, :536-559); any other character triggers a complex fix (simple fix
  + full lowercase, :455-460); any period triggers acronym processing
  (:479-527) — strip edge periods, collapse true acronyms (periods at all odd
  positions), otherwise split on periods keeping pieces of length >= 2.
- Tokens longer than 16 chars AND >= 100 UTF-8 bytes are dropped (:439-453).
- Opt-in tag-span recording (``TagTokenizer(record_tags=True)``): begin tags
  push (name, attributes, token position); a matching end tag closes the most
  recent open tag into a :class:`Tag` span whose begin/end are TOKEN
  coordinates (begin=5 means the open tag sits between tokens 5 and 6 —
  Tag.java:8-29); spans sort by (begin asc, end desc) (:626-642, Tag.java:
  64-77); names are truncated below 256 UTF-8 bytes (Tag.java:41-62).

This is a new implementation (regex-assisted scan), not a port of the Java
character loop.
"""

from __future__ import annotations

import unicodedata
from dataclasses import dataclass, field

_SPLIT_CHARS = set(';"&/:!#?$%()@^*+-,=><[]{}|`~_') | {chr(c) for c in range(33)}
_IGNORED_TAGS = frozenset(("style", "script"))
_MAX_TOKEN_BYTES = 100


def _is_space_char(c: str) -> bool:
    # Java Character.isSpaceChar == Unicode space separator categories
    # (NOT \t/\n/\r).
    return c == " " or unicodedata.category(c) in ("Zs", "Zl", "Zp")


def _simple_fix(token: str) -> str:
    out = []
    for c in token:
        if "A" <= c <= "Z":
            out.append(chr(ord(c) + 32))
        elif c == "'":
            continue
        else:
            out.append(c)
    return "".join(out)


def _complex_fix(token: str) -> str:
    return _simple_fix(token).lower()


def _classify(token: str) -> int:
    """0=clean, 1=simple fix, 2=complex fix, 3=acronym processing."""
    status = 0
    for c in token:
        if "a" <= c <= "z" or "0" <= c <= "9":
            continue
        if c == ".":
            return 3
        if (("A" <= c <= "Z") or c == "'") and status == 0:
            status = 1
        elif not (("A" <= c <= "Z") or c == "'"):
            status = 2
    return status


def _parse_attr(raw: str) -> tuple[str, str] | None:
    """One raw attribute chunk -> (lowercased name, unquoted value); bare
    attributes get an empty value; a bare quote run yields None."""
    raw = raw.strip()
    if not raw:
        return None
    key, eq, value = raw.partition("=")
    key = key.strip().lower()
    if not key or key[0] in "\"'":  # bare quote run is not an attribute
        return None
    value = value.strip()
    if len(value) >= 2 and value[0] in "\"'" and value[-1] == value[0]:
        value = value[1:-1]
    return key, value


def _truncate_tag_name(name: str) -> str:
    """Keep the name under 256 UTF-8 bytes (Tag.java:41-62)."""
    if len(name) > 32:
        while len(name.encode("utf-8")) >= 256:
            name = name[:256] if len(name) > 256 else name[:-1]
    return name


@dataclass
class Tag:
    """A markup span in TOKEN coordinates: begin=5 means the open tag sits
    between tokens 5 and 6 (Tag.java:8-29). Ordered by (begin asc, end
    desc) — an enclosing tag sorts before the tags it contains."""

    name: str
    attributes: dict = field(default_factory=dict)
    begin: int = 0
    end: int = 0

    def __post_init__(self) -> None:
        self.name = _truncate_tag_name(self.name)

    def sort_key(self):
        return (self.begin, -self.end)

    def __str__(self) -> str:
        attrs = "".join(f' {k}="{v}"' for k, v in self.attributes.items())
        return f"<{self.name}{attrs}>"


class TagTokenizer:
    """Stateful single-document tokenizer; use :func:`tokenize` for one-shots.

    With ``record_tags=True``, ``self.tags`` holds the document's markup
    structure as sorted :class:`Tag` spans after :meth:`tokenize` (the
    reference engine never consumes them — SURVEY.md §2.3 — but the parsed
    Document model carries them; collection/parsers.py)."""

    def __init__(self, record_tags: bool = False) -> None:
        self.tokens: list[str] = []
        self.tags: list[Tag] = []
        self._record_tags = record_tags
        self._text = ""
        self._ignore_until: str | None = None
        self._open_tags: list[tuple[str, dict, int]] = []

    def tokenize(self, text: str) -> list[str]:
        self.tokens = []
        self.tags = []
        self._open_tags = []
        self._text = text
        self._ignore_until = None
        n = len(text)
        pos = 0
        last_split = -1

        while 0 <= pos < n:
            c = text[pos]
            if c == "<":
                if self._ignore_until is None:
                    self._on_token(last_split + 1, pos)
                pos = self._on_start_bracket(pos)
                last_split = pos
            elif self._ignore_until is not None:
                pass
            elif c == "&":
                self._on_token(last_split + 1, pos)
                last_split = pos
                skip_to = self._entity_end(pos)
                if skip_to is not None:
                    pos = skip_to
                    last_split = skip_to
            elif ord(c) < 256 and c in _SPLIT_CHARS:
                self._on_token(last_split + 1, pos)
                last_split = pos
            pos += 1

        if self._ignore_until is None:
            self._on_token(last_split + 1, n)
        if self._record_tags:
            self.tags.sort(key=Tag.sort_key)
        return self.tokens

    # -- token emission ---------------------------------------------------

    def _on_token(self, start: int, end: int) -> None:
        if end <= start:
            return
        token = self._text[start:end]
        status = _classify(token)
        if status == 1:
            self._add(_simple_fix(token))
        elif status == 2:
            self._add(_complex_fix(token))
        elif status == 3:
            self._acronym(token)
        else:
            self._add(token)

    def _add(self, token: str) -> None:
        if not token:
            return
        if len(token) > _MAX_TOKEN_BYTES // 6 and len(token.encode("utf-8")) >= _MAX_TOKEN_BYTES:
            return
        self.tokens.append(token)

    def _acronym(self, token: str) -> None:
        token = _complex_fix(token)
        token = token.strip(".")
        if "." in token:
            is_acronym = len(token) > 0 and all(
                token[i] == "." for i in range(1, len(token), 2)
            )
            if is_acronym:
                self._add(token.replace(".", ""))
            else:
                for piece in token.split("."):
                    if len(piece) > 1:
                        self._add(piece)
        else:
            self._add(token)

    # -- markup handling --------------------------------------------------

    def _entity_end(self, pos: int) -> int | None:
        """Index of the ';' ending a valid entity starting at '&', else None."""
        text = self._text
        for i in range(pos + 1, len(text)):
            c = text[i]
            if ("a" <= c <= "z") or ("0" <= c <= "9") or c == "#":
                continue
            if c == ";":
                return i
            break
        return None

    def _on_start_bracket(self, pos: int) -> int:
        text = self._text
        n = len(text)
        if pos + 1 >= n:
            return n
        c = text[pos + 1]
        if c == "/":
            return self._parse_end_tag(pos)
        if self._ignore_until is not None:
            # inside <style>/<script> only the matching end tag can change
            # state: markup-looking content (document.write("<style>"))
            # must not re-arm the ignore or start a comment/PI skip, else
            # the real end tag never matches and the rest of the document
            # silently drops
            end = text.find(">", pos + 1)
            return n if end < 0 else end
        if c == "!":
            return self._skip_comment(pos)
        if c == "?":
            end = text.find("?>", pos + 1)
            return n if end < 0 else end
        return self._parse_begin_tag(pos)

    def _skip_comment(self, pos: int) -> int:
        text = self._text
        if text.startswith("<!--", pos):
            end = text.find("-->", pos + 1)
            return len(text) if end < 0 else end + 2
        end = text.find(">", pos + 1)
        return len(text) if end < 0 else end

    def _tag_name_end(self, start: int) -> int:
        text = self._text
        i = start
        while i < len(text) and not (_is_space_char(text[i]) or text[i] == ">"):
            i += 1
        return i

    def _parse_end_tag(self, pos: int) -> int:
        text = self._text
        i = self._tag_name_end(pos + 2)
        name = text[pos + 2 : i].lower()
        if self._ignore_until is not None and self._ignore_until == name:
            self._ignore_until = None
        if self._record_tags and self._ignore_until is None:
            self._close_tag(name)
        while i < len(text) and text[i] != ">":
            i += 1
        return i

    def _close_tag(self, name: str) -> None:
        """Close the MOST RECENT matching open tag into a token-coordinate
        span (unmatched end tags are dropped, like the reference's stack
        scan, TagTokenizer.java:179-202)."""
        for j in range(len(self._open_tags) - 1, -1, -1):
            if self._open_tags[j][0] == name:
                _, attrs, begin = self._open_tags.pop(j)
                self.tags.append(Tag(name, attrs, begin, len(self.tokens)))
                return

    def _parse_begin_tag(self, pos: int) -> int:
        text = self._text
        n = len(text)
        i = self._tag_name_end(pos + 1)
        name = text[pos + 1 : i].lower()

        # advance over attributes to the tag-closing '>' (or text end),
        # honoring quoted attribute values; detect self-closing '/>'
        close_it = False
        if name.endswith("/"):  # attribute-less self-close: <br/>
            name = name[:-1]
            close_it = True
        attrs: dict = {}
        while i < n and _is_space_char(text[i]):
            i += 1
        if i >= n:
            i = n
        elif text[i] == ">":
            pass
        else:
            tag_end = text.find(">", i + 1)
            if tag_end < 0:
                pass  # malformed: resume scanning right after the name
            else:
                while i < tag_end:
                    start = i
                    while start < tag_end and _is_space_char(text[start]):
                        start += 1
                    if text[start] == ">":
                        i = start
                        break
                    if text[start] == "/" and start + 1 < n and text[start + 1] == ">":
                        i = start + 1
                        close_it = True
                        break
                    end = self._attr_end(start, tag_end)
                    if end is None:
                        i = tag_end
                        break
                    i = end
                    if i < n and text[i] in "\"'":
                        i += 1
                    if self._record_tags:
                        kv = _parse_attr(text[start:i])
                        if kv is not None:
                            attrs[kv[0]] = kv[1]

        if self._record_tags and self._ignore_until is None:
            if close_it:
                # self-closing tag: an empty span at the current position
                self.tags.append(Tag(name, attrs,
                                     len(self.tokens), len(self.tokens)))
            else:
                self._open_tags.append((name, attrs, len(self.tokens)))

        if name in _IGNORED_TAGS and not close_it:
            self._ignore_until = name
        return i

    def _attr_end(self, start: int, tag_end: int) -> int | None:
        """End index of one attribute (first unquoted space-char or '>')."""
        text = self._text
        in_quote = False
        escaped = False
        for i in range(start, tag_end + 1):
            c = text[i]
            if c in "\"'" and not escaped:
                in_quote = not in_quote
                if not in_quote:
                    return i
            elif not in_quote and (_is_space_char(c) or c == ">"):
                return i
            elif c == "\\" and not escaped:
                escaped = True
                continue
            escaped = False
        return None


def tokenize(text: str) -> list[str]:
    return TagTokenizer().tokenize(text)
