"""Faults planted in the program under test, to show that the comparison
catches them: each a context manager that patches joeys2t_torch while it
is open. ``tests/test_bench_faults.py`` runs the cells with them on the CPU and
``calibrate.py --fault`` at the cells' sizes on the card."""
import contextlib

import numpy as np


@contextlib.contextmanager
def patched(owner, name, replacement):
    original = getattr(owner, name)
    setattr(owner, name, replacement(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def unchanged_state():
    """An update that leaves the weights and the optimizer's state as they were."""
    from joeys2t_torch import optim

    return patched(optim.Adam, "step", lambda original: lambda self, closure=None: None)


def half_batch():
    """Each micro-batch loses its second half of rows; the loss is the mean
    over the rest."""
    from joeys2t_torch.training import TrainManager

    def replacement(original):
        def train_prepared(self, prepared):
            nseqs, ntokens, arrays, normalizer = prepared
            keep = max(nseqs // 2, 1)
            cut = {k: (v[:keep] if v is not None and v.dim() > 0 and v.shape[0] == nseqs else v)
                   for k, v in arrays.items()}
            return original(self, (keep, ntokens, cut, normalizer * keep / nseqs))
        return train_prepared

    return patched(TrainManager, "_train_prepared", replacement)


def altered_transcript():
    """Each greedy row's first id, as search produces it, replaced by another
    entry of the vocabulary (4, or 5 where it was 4)."""
    from joeys2t_torch import serving

    def replacement(original):
        def greedy(*args, **kwargs):
            out, scores, att = original(*args, **kwargs)
            out = out.copy()
            out[:, 0] = np.where(out[:, 0] == 4, 5, 4)
            return out, scores, att
        return greedy

    return patched(serving, "transformer_greedy", replacement)


def altered_translation():
    """Each hypothesis's first token replaced by another id (4, or 5 where it was 4)."""
    from joeys2t_torch import search

    def replacement(original):
        def search_(*args, **kwargs):
            out, scores, att = original(*args, **kwargs)
            out = out.copy()
            out[:, 0] = np.where(out[:, 0] == 4, 5, 4)
            return out, scores, att
        return search_

    return patched(search, "search", replacement)


def worse_candidates():
    """The beam step keeps the candidates ranked beam + 1 to 2 x beam, with
    their true scores, in place of the beam best (the hypothesis store's own
    selection left as it is)."""
    from joeys2t_torch import search

    def replacement(original):
        def topk(x, k):
            if x.shape[-1] <= 2 * k:  # the store of finished hypotheses
                return original(x, k)
            values, indices = original(x, 2 * k)
            return values[..., k:], indices[..., k:]
        return topk

    return patched(search, "_stable_topk", replacement)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_transcript": altered_transcript, "altered_translation": altered_translation,
          "worse_candidates": worse_candidates}
