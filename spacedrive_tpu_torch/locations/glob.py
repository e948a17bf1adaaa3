"""Globset-compatible glob matching.

The port's own copy of ``spacedrive_tpu/locations/glob.py``, unchanged.

The reference filters indexer entries with Rust's `globset` crate using
default settings (upstream core/src/location/indexer/rules/mod.rs:188-210
via `Glob::parse`), whose semantics differ from Python's fnmatch:

- `*` and `?` match across `/` (default `literal_separator = false`);
- `**` must form its own path component and matches any number of
  components (including zero when written `**/`);
- `{a,b,c}` alternation, possibly nested;
- `[...]` character classes with `!` negation;
- matches are anchored: the glob must cover the whole path string.

Implemented as a translator to Python regex.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Sequence


class GlobError(ValueError):
    pass


def _translate(glob: str) -> str:
    out: List[str] = []
    i, n = 0, len(glob)
    while i < n:
        c = glob[i]
        if c == "*":
            if glob.startswith("**", i):
                # `**` must be a complete component (globset InvalidRecursive).
                prev_ok = i == 0 or glob[i - 1] in "/{,"
                nxt = i + 2
                next_ok = nxt >= n or glob[nxt] in "/},"
                if not (prev_ok and next_ok):
                    raise GlobError(
                        f"recursive wildcard must form a single component: {glob!r}"
                    )
                if nxt < n and glob[nxt] == "/":
                    # `**/` — zero or more whole components.
                    out.append(r"(?s:.*/)?")
                    i = nxt + 1
                else:
                    out.append(r"(?s:.*)")
                    i = nxt
            else:
                out.append(r"(?s:.*)")
                i += 1
        elif c == "?":
            out.append(r"(?s:.)")
            i += 1
        elif c == "[":
            j = i + 1
            if j < n and glob[j] in "!^":
                j += 1
            if j < n and glob[j] == "]":
                j += 1
            while j < n and glob[j] != "]":
                j += 1
            if j >= n:
                raise GlobError(f"unclosed character class: {glob!r}")
            inner = glob[i + 1:j]
            if inner.startswith("!"):
                inner = "^" + inner[1:]
            inner = inner.replace("\\", "\\\\")
            out.append(f"[{inner}]")
            i = j + 1
        elif c == "{":
            # Find the matching close brace (nesting allowed).
            depth, j = 1, i + 1
            while j < n and depth:
                if glob[j] == "{":
                    depth += 1
                elif glob[j] == "}":
                    depth -= 1
                j += 1
            if depth:
                raise GlobError(f"unclosed alternation: {glob!r}")
            body = glob[i + 1:j - 1]
            # Split on top-level commas only.
            parts, buf, d = [], [], 0
            for ch in body:
                if ch == "{":
                    d += 1
                elif ch == "}":
                    d -= 1
                if ch == "," and d == 0:
                    parts.append("".join(buf))
                    buf = []
                else:
                    buf.append(ch)
            parts.append("".join(buf))
            out.append("(?:" + "|".join(_translate(p) for p in parts) + ")")
            i = j
        else:
            out.append(re.escape(c))
            i += 1
    return "".join(out)


class Glob:
    def __init__(self, pattern: str):
        self.pattern = pattern
        self._re = re.compile(r"(?s:\A" + _translate(pattern) + r")\Z")

    def is_match(self, path: str) -> bool:
        return self._re.match(path) is not None

    def __repr__(self) -> str:
        return f"Glob({self.pattern!r})"


class GlobSet:
    """Any-match set over several globs (globset::GlobSet::is_match)."""

    def __init__(self, patterns: Iterable[str]):
        self.globs: Sequence[Glob] = [Glob(p) for p in patterns]

    def is_match(self, path: str) -> bool:
        return any(g.is_match(path) for g in self.globs)

    @property
    def patterns(self) -> List[str]:
        return [g.pattern for g in self.globs]
