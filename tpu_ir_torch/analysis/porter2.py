"""Porter2 ("english" Snowball) stemmer, implemented from the published algorithm.

Behavior-parity target: the generated Snowball Java stemmer vendored by the
reference (org/tartarus/snowball/ext/englishStemmer.java) — the classic Porter2
revision whose exception lists are {skis, skies, dying, lying, tying, idly,
gently, ugly, early, only, singly, sky, news, howe, atlas, cosmos, bias, andes}
and {inning, outing, canning, herring, earring, proceed, exceed, succeed}.
Words shorter than 3 characters are returned unchanged (reference stem()
driver, englishStemmer.java:1176-1195).

This is a fresh Python implementation from the public algorithm description,
not a translation of the generated suffix-automaton code.
"""

from __future__ import annotations

VOWELS = frozenset("aeiouy")
DOUBLES = ("bb", "dd", "ff", "gg", "mm", "nn", "pp", "rr", "tt")
VALID_LI = frozenset("cdeghkmnrt")

# Whole-word exceptions applied before anything else (reference a_10 table).
EXCEPTION1 = {
    "skis": "ski", "skies": "sky",
    "dying": "die", "lying": "lie", "tying": "tie",
    "idly": "idl", "gently": "gentl", "ugly": "ugli",
    "early": "earli", "only": "onli", "singly": "singl",
    # invariants
    "sky": "sky", "news": "news", "howe": "howe",
    "atlas": "atlas", "cosmos": "cosmos", "bias": "bias", "andes": "andes",
}

# Whole-word exceptions applied after step 1a (reference a_9 table).
EXCEPTION2 = frozenset(
    ("inning", "outing", "canning", "herring", "earring",
     "proceed", "exceed", "succeed")
)

STEP2_SUFFIXES = (
    # (suffix, replacement); "li" and "ogi" handled specially below.
    ("ational", "ate"), ("fulness", "ful"), ("iveness", "ive"),
    ("ization", "ize"), ("ousness", "ous"), ("biliti", "ble"),
    ("lessli", "less"), ("tional", "tion"), ("alism", "al"),
    ("aliti", "al"), ("ation", "ate"), ("entli", "ent"), ("fulli", "ful"),
    ("iviti", "ive"), ("ousli", "ous"), ("abli", "able"), ("alli", "al"),
    ("anci", "ance"), ("ator", "ate"), ("enci", "ence"), ("izer", "ize"),
    ("bli", "ble"),
)

STEP3_SUFFIXES = (
    ("ational", "ate"), ("tional", "tion"), ("alize", "al"),
    ("icate", "ic"), ("iciti", "ic"), ("ical", "ic"),
    ("ful", ""), ("ness", ""),
)

STEP4_SUFFIXES = (
    "ement", "ance", "ence", "able", "ible", "ment",
    "ant", "ent", "ism", "ate", "iti", "ous", "ive", "ize",
    "al", "er", "ic",
)


def _is_vowel(word: str, i: int) -> bool:
    return word[i] in VOWELS


def _mark_regions(word: str) -> tuple[int, int]:
    """R1/R2 start offsets; len(word) when the region is empty."""
    n = len(word)
    r1 = n
    # Special prefixes fix R1 (reference a_0 table).
    for prefix in ("gener", "commun", "arsen"):
        if word.startswith(prefix):
            r1 = len(prefix)
            break
    else:
        for i in range(n - 1):
            if _is_vowel(word, i) and not _is_vowel(word, i + 1):
                r1 = i + 2
                break
    r2 = n
    for i in range(r1, n - 1):
        if _is_vowel(word, i) and not _is_vowel(word, i + 1):
            r2 = i + 2
            break
    return r1, r2


def _ends_short_syllable(word: str) -> bool:
    """True if the word ends in a short syllable (Porter2 definition)."""
    n = len(word)
    if n == 2:
        return _is_vowel(word, 0) and not _is_vowel(word, 1)
    if n >= 3:
        # non-vowel, vowel, non-vowel that is not w/x/Y
        return (
            _is_vowel(word, n - 2)
            and not _is_vowel(word, n - 3)
            and word[n - 1] not in VOWELS
            and word[n - 1] not in "wxY"
        )
    return False


def _is_short(word: str, r1: int) -> bool:
    return r1 >= len(word) and _ends_short_syllable(word)


def _contains_vowel(s: str) -> bool:
    return any(c in VOWELS for c in s)


def stem(word: str) -> str:
    """Stem one lowercase word. Non-ASCII input is returned as-is wherever the
    algorithm's vowel/consonant logic does not apply; behavior for pure a-z
    words matches the Snowball english stemmer."""
    if len(word) < 3:
        return word
    if word in EXCEPTION1:
        return EXCEPTION1[word]

    # --- prelude ---
    if word[0] == "'":
        word = word[1:]
        if len(word) < 1:
            return word
    y_found = False
    if word and word[0] == "y":
        word = "Y" + word[1:]
        y_found = True
    chars = list(word)
    for i in range(1, len(chars)):
        if chars[i] == "y" and chars[i - 1] in VOWELS:
            chars[i] = "Y"
            y_found = True
    word = "".join(chars)

    r1, r2 = _mark_regions(word)

    # --- step 0: strip 's / 's' / ' ---
    for suf in ("'s'", "'s", "'"):
        if word.endswith(suf):
            word = word[: -len(suf)]
            break

    # --- step 1a ---
    if word.endswith("sses"):
        word = word[:-2]
    elif word.endswith(("ied", "ies")):
        word = word[:-3] + ("i" if len(word) > 4 else "ie")
    elif word.endswith(("us", "ss")):
        pass
    elif word.endswith("s"):
        # delete if the stem before the final s has a vowel not immediately
        # before the s
        if _contains_vowel(word[:-2]):
            word = word[:-1]

    if word in EXCEPTION2:
        return word

    # --- step 1b ---
    step1b_suffix = None
    for suf in ("eedly", "ingly", "edly", "eed", "ing", "ed"):
        if word.endswith(suf):
            step1b_suffix = suf
            break
    if step1b_suffix in ("eed", "eedly"):
        if len(word) - len(step1b_suffix) >= r1:
            word = word[: -len(step1b_suffix)] + "ee"
    elif step1b_suffix is not None:
        stem_part = word[: -len(step1b_suffix)]
        if _contains_vowel(stem_part):
            word = stem_part
            if word.endswith(("at", "bl", "iz")):
                word += "e"
            elif word.endswith(DOUBLES):
                word = word[:-1]
            elif _is_short(word, r1):
                word += "e"

    # --- step 1c: y -> i after a consonant that is not word-initial ---
    if (
        len(word) > 2
        and word[-1] in "yY"
        and word[-2] not in VOWELS
    ):
        word = word[:-1] + "i"

    # --- step 2 (longest suffix, in R1) ---
    for suf, repl in STEP2_SUFFIXES:
        if word.endswith(suf):
            if len(word) - len(suf) >= r1:
                word = word[: -len(suf)] + repl
            break
    else:
        if word.endswith("ogi"):
            if len(word) - 3 >= r1 and len(word) >= 4 and word[-4] == "l":
                word = word[:-1]
        elif word.endswith("li"):
            if len(word) - 2 >= r1 and len(word) >= 3 and word[-3] in VALID_LI:
                word = word[:-2]

    # --- step 3 (longest suffix, in R1; "ative" needs R2) ---
    for suf, repl in STEP3_SUFFIXES:
        if word.endswith(suf):
            if len(word) - len(suf) >= r1:
                word = word[: -len(suf)] + repl
            break
    else:
        if word.endswith("ative"):
            if len(word) - 5 >= r1 and len(word) - 5 >= r2:
                word = word[:-5]

    # --- step 4 (longest suffix, in R2) ---
    for suf in STEP4_SUFFIXES:
        if word.endswith(suf):
            if len(word) - len(suf) >= r2:
                word = word[: -len(suf)]
            break
    else:
        if word.endswith(("sion", "tion")):
            if len(word) - 3 >= r2:
                word = word[:-3]

    # --- step 5 ---
    if word.endswith("e"):
        if len(word) - 1 >= r2 or (
            len(word) - 1 >= r1 and not _ends_short_syllable(word[:-1])
        ):
            word = word[:-1]
    elif word.endswith("l"):
        if len(word) - 1 >= r2 and len(word) >= 2 and word[-2] == "l":
            word = word[:-1]

    # --- postlude ---
    if y_found:
        word = word.replace("Y", "y")
    return word


class Porter2Stemmer:
    """Memoizing stemmer facade mirroring the reference analyzer's 50k-entry
    cache-clear policy (reference GalagoTokenizer.java:158-178)."""

    def __init__(self, cache_limit: int = 50000):
        self._cache: dict[str, str] = {}
        self._cache_limit = cache_limit

    def stem(self, word: str) -> str:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        out = stem(word)
        self._cache[word] = out
        if len(self._cache) > self._cache_limit:
            self._cache.clear()
        return out
