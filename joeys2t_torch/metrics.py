# coding: utf-8
"""
Evaluation metrics (counterpart of joeys2t_tpu/metrics.py: ``token_accuracy``
:45, ``sequence_accuracy`` :58, ``wer`` :67). WER is the corpus-level sum of
token edit distances over the sum of reference lengths, with the port's own
edit distance. BLEU and chrF come with the MT legs and raise
``NotImplementedError``.
"""
from typing import Callable, List, Sequence


def bleu(hypotheses: List[str], references: List[str], **sacrebleu_cfg) -> float:
    raise NotImplementedError("BLEU is not ported yet")


def chrf(hypotheses: List[str], references: List[str], **sacrebleu_cfg) -> float:
    raise NotImplementedError("chrF is not ported yet")


def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance between two token sequences (unit costs)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i]
        for j, y in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (x != y)))
        prev = cur
    return prev[-1]


def token_accuracy(hypotheses: List, references: List, tokenizer: Callable) -> float:
    """Correct tokens over hypothesis tokens, position by position, in %."""
    if len(hypotheses) != len(references):
        raise ValueError("hypotheses and references differ in number")
    n_match = n_hyp_tokens = 0
    for hyp_str, ref_str in zip(hypotheses, references):
        hyp_toks, ref_toks = tokenizer(hyp_str), tokenizer(ref_str)
        n_hyp_tokens += len(hyp_toks)
        n_match += sum(int(h == r) for h, r in zip(hyp_toks, ref_toks))
    return (n_match / n_hyp_tokens) * 100 if n_hyp_tokens else 0.0


def sequence_accuracy(hypotheses: List[str], references: List[str]) -> float:
    """Exact sequence matches in %."""
    if len(hypotheses) != len(references):
        raise ValueError("hypotheses and references differ in number")
    if not hypotheses:
        return 0.0
    return sum(int(h == r) for h, r in zip(hypotheses, references)) / len(hypotheses) * 100


def wer(hypotheses: List[str], references: List[str], tokenizer: Callable) -> float:
    """Corpus word error rate in %: sum of edit distances over the sum of
    reference lengths."""
    pairs = [(tokenizer(hyp), tokenizer(ref)) for hyp, ref in zip(hypotheses, references)]
    numerator = float(sum(edit_distance(h, r) for h, r in pairs))
    denominator = float(sum(len(ref) for _, ref in pairs))
    return (numerator / denominator) * 100 if denominator else 0.0
