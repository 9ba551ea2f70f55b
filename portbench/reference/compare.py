"""The numbers that decide ``correct``.

Training, after three steps from the same weights on the same batches:

* ``loss_gap``: the largest relative gap between the program's loss and
  the reference's, over the steps;
* ``grad_gap``: the first step's gradient as the optimizer takes it
  (clipped), leaf by leaf: the largest gap between the two norms, over the
  reference's norm of that leaf or of the median leaf, whichever is larger;
* ``change_gap``: the same of the norm of each leaf's change over the
  three steps. Leaves whose reference gradient is under a thousandth of
  the median leaf's move by round-off alone and are left out;
* ``grad_diff_median``: the median over those leaves of the norm of the
  difference between the two first gradients, over the reference's norm
  of that leaf. A gap between two norms is second order in errors that
  are not aligned with the gradient, as rounding errors are; this
  difference is first order in them;
* ``grad_diff_min``: the same difference of the leaf that agrees best.
  Routing decisions that the rounding flips (a near-tie in the top-k, a
  pair at an expert's capacity) move whole tokens between experts and
  reach every leaf upstream of them; the best-agreeing leaf is the one
  with the fewest such decisions between it and the loss, so its
  difference is the one that shows the arithmetic's precision most
  plainly;
* ``change_diff_median``: the median over those leaves of the norm of
  the difference between the two parameters after the three steps, over
  the norm of the reference's change of that leaf. A gap of norms cannot
  see the update's direction: AdamW's first steps move each element by
  about lr times the sign of its moment, so an update of the wrong sign,
  or one from a stale gradient, changes each leaf by a norm as right as
  the sound one's; this difference reads about 2 for a reversed update
  and 1 for none.

Serving: ``logit_gap``, the widest gap by which a served token's logit
lies below the reference's best logit at that position; ``mean_gap``, its
mean over the served tokens checked; ``flip_share``, the share of them
that are not the reference's first choice.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence, Tuple

import torch

ROUNDING_SHARE = 1e-3


def _rel_gaps(prog: Dict, ref: Dict, keys, base: Dict = None
              ) -> Tuple[float, str]:
    """The largest |prog - base| over max(ref, the median of ref) by leaf
    (``base`` defaults to ``ref``: a gap between two norms), and where."""
    base = ref if base is None else base
    med = statistics.median(ref[k] for k in keys)
    worst, at = -1.0, ""
    for k in keys:
        g = abs(prog[k] - base[k]) / max(ref[k], med, 1e-30)
        if not math.isfinite(g):
            g = math.inf
        if g > worst:
            worst, at = g, "/".join(str(p) for p in k)
    return worst, at


def train_numbers(prog: Dict, ref: Dict, diff: Dict = None) -> Dict:
    """``prog`` and ``ref``: {"loss": [...], "grad_norm": {path: v},
    "change": {path: v}}; ``diff``: {"grad_diff": {path: ||g_prog -
    g_ref||}, "param_diff": {path: ||p_prog - p_ref|| after the steps}}
    where the two runs' leaves were set side by side."""
    losses = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
              for a, b in zip(prog["loss"], ref["loss"])]
    keys = sorted(ref["grad_norm"], key=str)
    grad_gap, grad_at = _rel_gaps(prog["grad_norm"], ref["grad_norm"], keys)
    med = statistics.median(ref["grad_norm"][k] for k in keys)
    moved = [k for k in keys if ref["grad_norm"][k] >= ROUNDING_SHARE * med]
    change_gap, change_at = _rel_gaps(prog["change"], ref["change"], moved)
    out = {"loss_gap": max(losses), "loss1_gap": losses[0],
           "grad_gap": grad_gap, "change_gap": change_gap,
           "worst_grad_leaf": grad_at, "worst_change_leaf": change_at,
           "left_out": ["/".join(map(str, k)) for k in keys
                        if k not in moved]}
    if diff and diff.get("grad_diff"):
        zero = {k: 0.0 for k in keys}
        out["grad_diff"], out["worst_grad_diff_leaf"] = _rel_gaps(
            diff["grad_diff"], ref["grad_norm"], keys, base=zero)
        out["change_diff"], out["worst_change_diff_leaf"] = _rel_gaps(
            diff["param_diff"], ref["change"], moved, base=zero)
        rel = {"/".join(map(str, k)): diff["grad_diff"][k]
               / max(ref["grad_norm"][k], 1e-30) for k in moved}
        out["grad_diff_median"] = statistics.median(rel.values())
        out["change_diff_median"] = statistics.median(
            diff["param_diff"][k] / max(ref["change"][k], 1e-30)
            for k in moved)
        out["grad_diff_min"] = min(rel.values())
        out["grad_diff_by_leaf"] = rel
    return out


def logit_gaps(ref_logits: torch.Tensor, tokens: Sequence[int]) -> List[float]:
    """Per position: the reference's best logit less its logit of the
    token served there."""
    t = torch.as_tensor(list(tokens), device=ref_logits.device).long()
    best = ref_logits.max(-1).values
    got = ref_logits.gather(-1, t[:, None])[:, 0]
    return (best - got).float().cpu().tolist()


def gap_numbers(gaps: Sequence[float]) -> Dict[str, float]:
    """The widest gap, the mean gap and the share of served tokens that
    are not the reference's first choice (NaN without tokens)."""
    if not gaps:
        return {"logit_gap": math.nan, "mean_gap": math.nan,
                "flip_share": math.nan}
    return {"logit_gap": max(gaps), "mean_gap": sum(gaps) / len(gaps),
            "flip_share": sum(g > 0 for g in gaps) / len(gaps)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number finite and within its limit."""
    return all(k in numbers and math.isfinite(numbers[k])
               and numbers[k] <= lim for k, lim in limits.items())
