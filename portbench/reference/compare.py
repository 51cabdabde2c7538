"""The numbers that decide ``correct``, each worked out from the program's
readings and the reference's."""
import statistics
from typing import Dict, Iterable, List, Sequence


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], names: Iterable[str]) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the median
    leaf (some leaves are all but zero)."""
    names = list(names)
    median = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30) for n in names)


def moved_leaves(ref_grad: Dict[str, float], share: float = 1e-3) -> List[str]:
    """The leaves whose reference gradient is at least ``share`` of the
    median leaf's; the others (a key's bias under softmax) move under Adam by
    round-off alone."""
    median = statistics.median(ref_grad.values())
    return sorted(n for n, g in ref_grad.items() if g >= share * median)


def train_numbers(prog_losses: Sequence[float], ref_losses: Sequence[float],
                  prog_grad: Dict[str, float], ref_grad: Dict[str, float],
                  prog_change: Dict[str, float], ref_change: Dict[str, float]) -> Dict[str, float]:
    """``loss_gap``: the largest relative gap of a step's loss;
    ``grad_gap``: the first update's gradient as the optimizer takes it;
    ``change_gap``: the parameters' change after the checked updates, over
    the leaves the reference's gradient moves."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog_losses, ref_losses))
    return {"loss_gap": loss_gap,
            "grad_gap": leaf_gap(prog_grad, ref_grad, ref_grad),
            "change_gap": leaf_gap(prog_change, ref_change, moved_leaves(ref_grad))}
