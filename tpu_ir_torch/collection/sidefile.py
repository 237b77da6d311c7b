"""Count-headed line side files — the shared on-disk shape of docnos.txt
and vocab.txt ('N\\n' then one entry per line, UTF-8, written atomically).
One definition so a format fix cannot land in one twin and not the other
(the DistributedCache-style side files the reference replicated to every
worker, DocnoMapping.java:42-72)."""

from __future__ import annotations

import os
from typing import Sequence


def save_lines(path: str | os.PathLike, lines: Sequence[str]) -> None:
    tmp = f"{os.fspath(path)}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(f"{len(lines)}\n")
        for x in lines:
            f.write(x + "\n")
    os.replace(tmp, path)


def load_lines(path: str | os.PathLike) -> list[str]:
    # readline splits on \n ONLY (unlike splitlines), so entries keep
    # any exotic Unicode line separators the analyzer allows in tokens
    with open(path, encoding="utf-8") as f:
        n = int(f.readline())
        return [f.readline().rstrip("\n") for _ in range(n)]
