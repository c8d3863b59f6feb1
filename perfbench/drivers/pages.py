"""One client streams pages into ``engine.ocr_pages`` with the mix's
``lookahead``.

The page iterator stops handing in pages once ``seconds`` have passed since
the first, and the call then drains what it holds.  The window runs from
handing in the first page to the call's return.
"""

from __future__ import annotations

import time

from perfbench.harness import system
from perfbench.harness.drive import Outcome


def warm(eng, pool: list, sched, mix: dict):
    """Capture every (bucket, padded batch) shape the pages dispatch, then
    run the first ``lookahead + 1`` pages once."""
    orientation = mix["orientation"]
    system.warm(eng, {(hw, n) for page in sched.pages
                      for hw, n, _ in system.dispatches([pool[j] for j in page], orientation)})
    first = sched.pages[:mix["lookahead"] + 1]
    system.pages(eng, [[pool[j] for j in page] for page in first], orientation, mix["lookahead"])
    return eng


def drive(eng, pool: list, sched, mix: dict, seconds: float) -> Outcome:
    handed: list[int] = []
    sizes: list[int] = []
    count = len(sched.pages)
    start = [0.0]

    def feed():
        i = 0
        while True:
            now = time.perf_counter()
            if i == 0:
                start[0] = now
            elif now - start[0] >= seconds:
                return
            page = sched.pages[i % count]
            handed.extend(page)
            sizes.append(len(page))
            yield [pool[j] for j in page]
            i += 1

    texts = system.pages(eng, feed(), mix["orientation"], mix["lookahead"])
    window = time.perf_counter() - start[0]
    answers = [t for page in texts for t in page]
    answers += [None] * (len(handed) - len(answers))
    return Outcome(handed, answers, window, page_sizes=sizes)
