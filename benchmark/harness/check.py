"""The numbers that decide ``correct``: the program's outputs against the
plain reference's, each held to the limit its cell's ``limits/<cell>.json``
gives (set from the lower reading of sound runs and the upper reading of
the control and the faults; ``PERF.md`` lists both)."""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import torch

#: Leaves whose reference gradient norm is below this share of the median
#: leaf's move by round-off alone under the optimizer: left out.
NOUGHT = 1e-3


def centred_logits(p: torch.Tensor) -> torch.Tensor:
    """Each row's logits up to the constant softmax drops: ``log p`` less
    its row mean (probabilities floored at 1e-30)."""
    lp = p.to(torch.float32).clamp(min=1e-30).log()
    return lp - lp.mean(1, keepdim=True)


class AnswerGap:
    """A run's answers against the reference's, block by block: the
    widest gap between an answer's centred logits and the reference's,
    each over its frame's logit scale (the size of the terms each logit
    sums, in the reference), so that the number follows the precision of
    the sums and not the size of a seed's logits."""

    def __init__(self):
        self.rows, self.widest = 0, []

    def add(self, answers: Iterable[torch.Tensor], reference: torch.Tensor,
            scale: torch.Tensor) -> None:
        """``answers``: probabilities ``[B, C]`` of the frames whose
        reference probabilities are ``reference``."""
        want = centred_logits(reference)
        for p in answers:
            p = p.to(reference.device, torch.float32)
            self.widest.append((centred_logits(p) - want).abs().amax(1)
                               / scale)
            self.rows += p.shape[0]

    def logit_gap(self) -> float:
        return float(torch.cat(self.widest).max())

    def over(self, limit: float) -> int:
        """Answers whose gap exceeds ``limit``."""
        return int((torch.cat(self.widest) > limit).sum())


def relative(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def worst_leaf(program: Dict[str, float], ref: Dict[str, float],
               kept: List[str]) -> Tuple[float, str]:
    """Largest |norm - norm_ref| over the kept leaves, each against the
    larger of its reference norm and the median kept leaf's."""
    med = sorted(ref[k] for k in kept)[len(kept) // 2]
    worst, name = 0.0, ""
    for k in kept:
        g = abs(program[k] - ref[k]) / max(ref[k], med, 1e-30)
        if g > worst or not name:
            worst, name = g, k
    return worst, name


def kept_leaves(ref_grad_norms: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient is not nought to rounding."""
    norms = sorted(ref_grad_norms.values())
    med = norms[len(norms) // 2]
    return [k for k, v in ref_grad_norms.items() if v >= NOUGHT * med]


def fit_numbers(records: Dict[str, dict], want: Dict[str, dict],
                starts: Dict[str, Dict[str, torch.Tensor]],
                detail: List[str] = None) -> Dict[str, float]:
    """The fit cells' numbers from the program's records of read steps and
    the reference's, by label (each a run of steps from the parameters
    ``starts[label]``): the worst step's loss and the parameters' change
    after the steps by its worst leaf, each the worst over the labels.
    ``detail`` gets a line a label naming the worst leaf and its two
    norms."""
    out = {"loss_gap": 0.0, "delta_gap": 0.0}
    for label, prog in records.items():
        ref, params0 = want[label], starts[label]
        kept = kept_leaves({k: float(v.norm())
                            for k, v in ref["first_grad"].items()})
        ref_d = {k: float((ref["params"][k] - params0[k]).norm())
                 for k in kept}
        prog_d = {k: float((prog["params"][k].to(params0[k].device)
                            - params0[k]).norm()) for k in kept}
        loss_gap = max(relative(a, b) for a, b in zip(prog["losses"],
                                                      ref["losses"]))
        delta_gap, leaf = worst_leaf(prog_d, ref_d, kept)
        out = {"loss_gap": max(out["loss_gap"], loss_gap),
               "delta_gap": max(out["delta_gap"], delta_gap)}
        if detail is not None:
            detail.append(
                f"{label}: loss_gap {loss_gap!r}, losses {prog['losses']} "
                f"against {ref['losses']}; delta_gap {delta_gap!r} at "
                f"{leaf}: {prog_d[leaf]!r} against {ref_d[leaf]!r}; leaves "
                f"kept {len(kept)} of {len(ref['first_grad'])}")
    return out


def judged(numbers: Dict[str, float], limits: Dict[str, float]
           ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """``(correct, {name: {"value", "limit"}})``; a number that is not
    finite fails."""
    shown = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    return ok, shown
