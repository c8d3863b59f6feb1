"""The readings that the limits of the check are set from, on the chip.

    python3 perfbench/tools/calibrate.py --workload int8.chapter --seeds 11,12,13 \
        --seconds 4 [--controls int4/fp8,int4/int8] [--out calibrate.jsonl]

For each seed, one run of the cell as ``run.py`` makes it (``runner.run``,
a short window at the cell's own load), whose check also judges, over the
same sample of answers and by the same comparison (``check.verdict``):

- ``control``: the tokens that the reference in the control's lower
  precision puts first, at each served position;
- ``altered``: one served token a row replaced by another id, as if the
  program had produced it;
- ``swapped``: each row of the second half of the sample replaced by a row
  of the first half that differs from it: answers handed to the wrong
  crops (``swapped_rows`` counts the rows changed; where every crop was
  answered alike there is nothing to swap);
- with ``--controls``, the control in each other precision named
  (``encoder/decoder`` modes of ``reference/model.py``).

One JSON line a seed: the program's readings, and each probe's readings
and whether it came out correct; also appended to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(
    os.path.abspath(__file__))]
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from perfbench.harness import check, runner  # noqa: E402


def alter(rows: list[list[int]], seed: int, vocab: int) -> list[list[int]]:
    """Each row with one served token (not BOS) replaced by another id."""
    rng = np.random.default_rng([int(seed) % 2**63, 9])
    out = []
    for r in rows:
        r = list(r)
        pos = int(rng.integers(1, len(r)))
        r[pos] = (r[pos] + int(rng.integers(1, vocab))) % vocab
        out.append(r)
    return out


def swap(rows: list[list[int]]) -> list[list[int]]:
    """Each row of the second half of ``rows`` replaced by the next row of
    the first half (in turn) that differs from it, where one does."""
    half = len(rows) - len(rows) // 2
    out = list(rows)
    for n, k in enumerate(range(half, len(rows))):
        others = [r for r in rows[:half] if r != rows[k]]
        if others:
            out[k] = others[n % len(others)]
    return out


def probe(controls: tuple[str, ...], seen: dict):
    """The ``runner.run`` probe of the control, the faults and ``controls``;
    ``seen`` gets the sample's count of distinct rows, of rows the swap
    changed, and the program's own readings in full."""

    def readings(tree, dims, cfg, crops, rows, orientation, device, seed):
        swapped = swap(rows)
        seen["distinct_rows"] = len({tuple(r) for r in rows})
        seen["swapped_rows"] = sum(1 for a, b in zip(rows, swapped) if a != b)

        def read(rs, **kw):
            return check.readings(tree, dims, cfg, crops, rs, orientation, device, **kw)

        def lower(r):
            return {k[len("control_"):]: v for k, v in r.items() if k.startswith("control_")
                    } | {"tokens": r["tokens"]}

        seen["program"] = read(rows)
        out = {"control": lower(read(rows, control=True)),
               "altered": read(alter(rows, seed, dims.decoder.vocab)),
               "swapped": read(swapped)}
        for name in controls:
            enc, dec = name.split("/")
            out[f"control {name}"] = lower(read(rows, control=True,
                                                precision={"encoder": enc, "decoder": dec}))
        return out

    return readings


def one(root: str, cell: str, seed: int, seconds: float, device: str,
        controls: tuple[str, ...] = ()) -> dict:
    args = runner.parse(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds)])
    seen: dict = {}
    result, _, compiles = runner.run(args, time.time(), root=root, device=device,
                                     look_for_device=device == "cuda",
                                     probe=probe(controls, seen))
    line = {"workload": cell, "seed": seed, "correct": result["correct"],
            "max_gap": result["check"]["max_gap"]["value"],
            "limit": result["check"]["max_gap"]["limit"],
            "tokens": result["check"]["compared_tokens"]["value"],
            "attempted": result["attempted"], "failed": result["failed"],
            "compiles_in_window": compiles, **seen}
    for name, p in result["probes"].items():
        line[name] = p
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    p.add_argument("--root", default=ROOT, help="the checkout whose BENCHMARK.json names the cell")
    p.add_argument("--controls", default="",
                   help="other control precisions, comma-separated encoder/decoder modes")
    args = p.parse_args(argv)
    for seed in [int(s) for s in args.seeds.split(",")]:
        line = one(args.root, args.workload, seed, args.seconds, args.device,
                   tuple(c for c in args.controls.split(",") if c))
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
