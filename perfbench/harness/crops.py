"""The crop pool every traffic mix draws from.

Speech-bubble crops as a detector cuts them from a scanned page: a light
paper background with some grain, and dark text-like strokes in vertical
columns (glyph-sized blocks of short bars, the style of the program's
synthetic page drawing, written out here in NumPy).  BGR uint8.

The crop sizes come from a fixed generator (``size_seed`` in the mix's
``pool`` group) and the pool holds them in that order, so every seed serves
the same sizes and a pool index names a size; the run's seed draws the
pixels, and the traffic's pattern the order in which crops are sent.
"""

from __future__ import annotations

import numpy as np


def sizes(pool: dict) -> np.ndarray:
    """[n, 2] (h, w) of the pool, uniform on the mix's ranges, from the
    fixed ``size_seed``."""
    rng = np.random.default_rng(pool.get("size_seed", 0))
    n = pool["size"]
    (h0, h1), (w0, w1) = pool["height"], pool["width"]
    h = rng.integers(h0, h1 + 1, size=n)
    w = rng.integers(w0, w1 + 1, size=n)
    return np.stack([h, w], axis=1)


def _draw(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    paper = int(rng.integers(220, 250))
    img = rng.integers(paper - 8, paper + 6, size=(h, w), dtype=np.int16)
    # glyph columns, right to left as vertical text is read
    glyph = max(10, min(h, w) // int(rng.integers(4, 9)))
    margin = max(2, glyph // 2)
    x = w - margin - glyph
    while x >= margin:
        y = margin
        stop = h - margin - glyph - int(rng.integers(0, max(1, h // 3)))
        while y <= stop:
            ink = int(rng.integers(0, 70))
            for _ in range(int(rng.integers(2, 6))):  # a glyph's bars
                if rng.random() < 0.5:  # horizontal bar
                    r = y + int(rng.integers(0, glyph))
                    c = x + int(rng.integers(0, glyph // 2))
                    img[r:r + 2, c:c + int(rng.integers(glyph // 3, glyph))] = ink
                else:  # vertical bar
                    c = x + int(rng.integers(0, glyph))
                    r = y + int(rng.integers(0, glyph // 2))
                    img[r:r + int(rng.integers(glyph // 3, glyph)), c:c + 2] = ink
            y += glyph + glyph // 4
        x -= glyph + glyph // 3
    gray = img.clip(0, 255).astype(np.uint8)
    return np.repeat(gray[..., None], 3, axis=-1)


def draw(pool: dict, seed: int) -> list[np.ndarray]:
    """The pool: ``pool["size"]`` BGR uint8 crops of the sizes ``sizes``
    gives, in its order, with pixels drawn from ``seed``."""
    rng = np.random.default_rng([int(seed) % 2**63, 1])
    return [_draw(rng, int(h), int(w)) for h, w in sizes(pool)]
