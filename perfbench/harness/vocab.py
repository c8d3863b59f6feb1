"""The benchmark's vocabulary: one visible character per token id.

Id ``i`` is the CJK ideograph U+4E00 + i.  The special ids (pad, BOS, EOS)
are ordinary characters here, so the program's detokenizer drops none and
its post-processing changes none: every served string spells the served
ids one for one, BOS first, EOS last where the row stopped.  That is what
lets the check judge the strings the timed path returned.
"""

from __future__ import annotations

BASE = 0x4E00
LIMIT = 0x9FFF  # the last CJK Unified Ideograph


def chars(n: int) -> list[str]:
    if BASE + n - 1 > LIMIT:
        raise ValueError(f"vocabulary of {n} ids exceeds the CJK block")
    return [chr(BASE + i) for i in range(n)]


def ids(text: str, n: int) -> list[int] | None:
    """The ids a served string spells, or None where a character is not
    one of the ``n`` ids (an error sentinel, say)."""
    out = []
    for ch in text:
        i = ord(ch) - BASE
        if not 0 <= i < n:
            return None
        out.append(i)
    return out
