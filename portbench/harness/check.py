"""The comparison that decides ``correct``.

Three layers are held to the plain reference:

- the training step: the first three steps' losses, each leaf's first
  gradient (from AdamW's first moment after one step) and each leaf's
  change over the three steps, against the architecture's plain
  reference (``reference/<name>.py``) from the same weights and batches;
  trained leaves only. A gap is taken by the worst leaf: the distance
  between the program's norm and the reference's, over the reference's
  norm of that leaf or of the median leaf, whichever is larger. Leaves
  whose reference gradient is under a thousandth of the median leaf's
  move by round-off alone and are left out of the change. A gap of norms
  hardly moves under rounding that is random from element to element, so
  the float8 control reads within 2x of the program there on Pythia-410M;
  ``grad_diff`` (the worst leaf's norm of the first gradient's difference,
  on the same scale) separates the two.
- the save: every leaf that reached storage, read by ``reference.reader``,
  against the state at the call, bit for bit (by fingerprint);
- the restore: the whole train state on the card after each restore
  (parameters, both moments, step counters, the RNG) against the state
  that was saved, bit for bit.
"""

from __future__ import annotations

import statistics
from typing import Any, Dict, List, Mapping, Optional, Tuple

GRAD_FLOOR = 1e-3  # of the median leaf's reference gradient norm


def _worst(values: Mapping[str, float], scales: Mapping[str, float], keys: List[str]) -> Tuple[float, str]:
    """The largest ``values[k]`` over the larger of ``scales[k]`` and the
    median scale, and its leaf."""
    if not keys:
        return 0.0, ""
    median = statistics.median(scales[k] for k in keys)
    worst, leaf = -1.0, ""
    for k in keys:
        scale = max(scales[k], median)
        g = values[k] / scale if scale > 0 else (0.0 if values[k] == 0 else float("inf"))
        if g > worst:
            worst, leaf = g, k
    return worst, leaf


def _gaps(prog: Mapping[str, float], ref: Mapping[str, float]) -> Dict[str, float]:
    return {k: abs(prog[k] - ref[k]) for k in ref}


def training_gaps(
    losses: List[float], grad_norms: Mapping[str, float], change_norms: Mapping[str, float],
    ref: Any, first_grads: Optional[Mapping[str, Any]] = None, first_scale: float = 1.0,
) -> Dict[str, Any]:
    """The numbers compared for the training step, with the leaves that set
    them (``ref`` is a ``reference.model.Readings``; ``first_grads`` the
    program's first gradients by leaf, as AdamW got them, each times
    ``first_scale``)."""
    if len(losses) != len(ref.losses):
        raise ValueError(f"{len(losses)} program losses against {len(ref.losses)} reference losses")
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(losses, ref.losses))
    keys = sorted(ref.grad_norms)
    if sorted(grad_norms) != keys or sorted(change_norms) != keys:
        raise ValueError("the program's leaves differ from the reference's")
    grad_gap, grad_leaf = _worst(_gaps(grad_norms, ref.grad_norms), ref.grad_norms, keys)
    floor = GRAD_FLOOR * statistics.median(ref.grad_norms.values())
    moved = [k for k in keys if ref.grad_norms[k] >= floor]
    change_gap, change_leaf = _worst(_gaps(change_norms, ref.change_norms), ref.change_norms, moved)
    out = {
        "loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
        "grad_leaf": grad_leaf, "change_leaf": change_leaf,
        "left_out": sorted(set(keys) - set(moved)),
    }
    if first_grads is not None:
        out["grad_diff"], out["diff_leaf"] = grad_diff(first_grads, ref.first_grads, ref.grad_norms, first_scale)
    return out


def grad_diff(
    prog: Mapping[str, Any], ref: Mapping[str, Any], ref_norms: Mapping[str, float], scale: float = 1.0,
) -> Tuple[float, str]:
    """The worst leaf's ``|scale * g_prog - g_ref|`` over the larger of its
    own and the median leaf's reference norm."""
    import torch

    keys = sorted(ref)
    if sorted(prog) != keys:
        raise ValueError("the program's first gradients name other leaves than the reference's")
    diffs = torch.stack([
        (prog[k].to(ref[k].device, torch.float32) * scale - ref[k]).norm() for k in keys
    ]).tolist()
    return _worst(dict(zip(keys, diffs)), ref_norms, keys)


def mismatched(expected: Mapping[str, Tuple], got: Mapping[str, Tuple]) -> List[str]:
    """Leaves whose signatures differ, or that one side lacks."""
    return sorted(k for k in set(expected) | set(got) if expected.get(k) != got.get(k))
