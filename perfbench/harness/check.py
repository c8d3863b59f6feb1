"""Whether what the timed path returned is correct.

After the window has closed, a sample of the crops that came back, drawn
from the seed and holding the longest answer, goes to the plain reference
(``perfbench/reference/model.py``) with the ids its string spells.  The
reference runs once over each crop and its served tokens (teacher forcing)
and reads, at every served position, how far the served token's logit lies
below the reference's best.  Two numbers are compared: the widest such gap
(a wrong token lies far below) and the mean over every served token (the
answers of other crops lie a little below at many tokens: with random
weights the model reads little of a crop, so their widest gap alone can
pass).  Greedy decoding serves the best token of the program's own logits,
so a sound program's gaps are rounding.

A string that spells no valid row (an unknown character, no BOS first, an
EOS before the end, a row that stopped early without EOS, one longer than
the budget) is malformed, and an answer that never came has failed: both
make the run incorrect whatever the gap.

``control`` is the same reference in the precision one step below the
configuration's: its reading is the gap, under the reference, of the token
the lower precision puts first.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.harness import vocab
from perfbench.reference import model as ref
from perfbench.reference.dims import Dims


def choose(lengths: list[int], count: int, seed: int) -> list[int]:
    """``count`` answer indices drawn from the seed, the longest answer
    first among them."""
    if not lengths:
        return []
    rng = np.random.default_rng([int(seed) % 2**63, 4])
    longest = int(np.argmax(lengths))
    rest = [i for i in rng.permutation(len(lengths)).tolist() if i != longest]
    return [longest] + rest[:count - 1]


def parse(text, dims: Dims) -> list[int] | None:
    """The token row a served string spells, or None where it spells none."""
    if not isinstance(text, str):
        return None
    d = dims.decoder
    ids = vocab.ids(text, d.vocab)
    if ids is None or len(ids) < 2 or len(ids) > dims.max_length or ids[0] != d.bos_id:
        return None
    if d.eos_id in ids[1:-1]:
        return None
    if len(ids) < dims.max_length and ids[-1] != d.eos_id:
        return None
    return ids


def verdict(read: dict, failed: int, malformed: int, cfg: dict) -> tuple[bool, dict]:
    """Whether a run is correct, and each number compared beside its limit:
    the widest gap of a token, the mean gap over every token compared, the
    answers that never came or spell no valid row, and the tokens compared
    (at least the configuration's ``min_tokens``)."""
    limit = cfg["check"]
    checks = {
        "max_gap": {"value": read["max_gap"], "limit": limit["max_gap"]},
        "mean_gap": {"value": read["mean_gap"], "limit": limit["max_mean_gap"]},
        "failed": {"value": failed, "limit": 0},
        "malformed": {"value": malformed, "limit": 0},
        "compared_tokens": {"value": read["tokens"], "limit": limit["min_tokens"]},
    }
    correct = (read["max_gap"] <= limit["max_gap"] and read["mean_gap"] <= limit["max_mean_gap"]
               and failed == 0 and malformed == 0
               and read["tokens"] >= limit["min_tokens"])
    return correct, checks


def _tally(out: dict, prefix: str, gap: torch.Tensor, valid: torch.Tensor) -> None:
    """Fold one block's gaps ([rows, T], ``valid`` marking served positions)
    into ``out``: the widest, the widest sum over one answer, the sum, and
    the positions off the reference's best."""
    gap = torch.where(valid, gap, torch.zeros_like(gap))
    out[prefix + "max_gap"] = max(out[prefix + "max_gap"], float(gap.max()))
    out[prefix + "row_gap"] = max(out[prefix + "row_gap"], float(gap.sum(1).max()))
    out[prefix + "mean_gap"] += float(gap.double().sum())
    out[prefix + "off_best"] += int((gap > 0).sum())


def readings(tree: dict, dims: Dims, cfg: dict, crops: list, rows: list[list[int]],
             orientation: str, device, control: bool = False, block: int = 32,
             precision: dict | None = None) -> dict:
    """Over ``rows`` (valid token rows) of ``crops``: the widest gap of a
    served token (``max_gap``), the widest sum of the gaps of one answer
    (``row_gap``), the mean gap, the served tokens off the reference's best
    (``off_best``) and the tokens compared; with ``control``, the same of
    the control's first tokens under ``control_`` names.  ``precision``
    replaces the configuration's control precision (the calibration tool
    tries several)."""
    ref.plain_float32()
    gelu_form = cfg["reference"]["encoder_gelu"]
    names = ("max_gap", "row_gap", "mean_gap", "off_best")
    out = {"tokens": 0} | {k: 0.0 for k in names}
    if control:
        out |= {"control_" + k: 0.0 for k in names}
    with torch.inference_mode():
        for a in range(0, len(rows), block):
            part = rows[a:a + block]
            t = max(len(r) for r in part)
            ids = torch.full((len(part), t), dims.decoder.pad_id, dtype=torch.long)
            valid = torch.zeros((len(part), t - 1), dtype=torch.bool)
            for i, r in enumerate(part):
                ids[i, :len(r)] = torch.tensor(r)
                valid[i, :len(r) - 1] = True
            ids, valid = ids.to(device), valid.to(device)
            inp, served = ids[:, :-1], ids[:, 1:]
            logits = ref.logits(tree, crops[a:a + block], inp, dims, orientation,
                                cfg["reference"]["precision"], gelu_form)
            _tally(out, "", ref.gaps(logits, served), valid)
            out["tokens"] += int(valid.sum())
            if control:
                low = ref.logits(tree, crops[a:a + block], inp, dims, orientation,
                                 precision or cfg["reference"]["control"], gelu_form)
                _tally(out, "control_", ref.gaps(logits, low.argmax(-1)), valid)
                del low
            del logits
    for key in ("mean_gap", "control_mean_gap"):
        if key in out:
            out[key] /= max(1, out["tokens"])
    return out
