# coding: utf-8
"""
Evaluation metrics (counterpart of joeys2t_tpu/metrics.py: ``chrf`` :34,
``bleu`` :40, ``token_accuracy`` :45, ``sequence_accuracy`` :58, ``wer``
:67). The JAX package scores BLEU and chrF with sacrebleu 2.x; the port
computes them itself, as sacrebleu's ``BLEU`` and ``CHRF`` classes do with
the options of ``sacrebleu_cfg`` their constructors take (an option of the
other metric is ignored; one of this metric that the port does not have
raises ``NotImplementedError``): corpus BLEU over 13a, intl, zh, char or
unsplit tokens (for a ``trg_lang`` of zh the zh tokenizer by default, as
sacrebleu; ja and ko, whose defaults need MeCab, raise)
with a brevity penalty and the smoothing methods none, floor, add-k and
exp; chrF and chrF++ over character and word n-grams. WER is the
corpus-level sum of token edit distances over the sum of reference lengths,
with the port's own edit distance.
"""
import math
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence

from joeys2t_torch.config import BLEU_DEFAULT_TOKENIZERS
from joeys2t_torch.tokenizers import tokenize_13a, tokenize_intl, tokenize_zh

_BLEU_TOKENIZERS = {"13a": tokenize_13a, "intl": tokenize_intl, "zh": tokenize_zh,
                    "char": " ".join, "none": lambda line: line}
_SMOOTH_DEFAULTS = {"none": None, "floor": 0.1, "add-k": 1, "exp": None}
_PUNCTS = set("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")


def _options(sacrebleu_cfg: Dict, accepted: Dict) -> Dict:
    """``accepted`` (the metric's constructor defaults) updated with the
    options of ``sacrebleu_cfg`` that the constructor takes."""
    return dict(accepted, **{k: v for k, v in sacrebleu_cfg.items() if k in accepted})


def _ngrams(tokens: Sequence[str], max_order: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for n in range(1, max_order + 1)
                   for i in range(len(tokens) - n + 1))


def bleu(hypotheses: List[str], references: List[str], **sacrebleu_cfg) -> float:
    """Corpus BLEU in [0, 100], as ``sacrebleu.metrics.BLEU(**cfg)
    .corpus_score(hypotheses, [references]).score`` (one reference each)."""
    opt = _options(sacrebleu_cfg, dict(
        lowercase=False, force=False, tokenize=None, smooth_method="exp",
        smooth_value=None, max_ngram_order=4, effective_order=False, trg_lang=""))
    tokenize = opt["tokenize"]
    if tokenize is None:
        tokenize = BLEU_DEFAULT_TOKENIZERS.get(opt["trg_lang"], "13a")
    if tokenize not in _BLEU_TOKENIZERS:
        raise NotImplementedError(f"BLEU tokenizer {tokenize!r} is not ported: it needs "
                                  f"MeCab or a downloaded SentencePiece model")
    smooth_method, order = opt["smooth_method"], int(opt["max_ngram_order"])
    if smooth_method not in _SMOOTH_DEFAULTS:
        raise ValueError(f"Unknown smooth_method {smooth_method!r}")
    if len(hypotheses) != len(references):
        raise ValueError("hypotheses and references differ in number")

    def prepare(sent: str) -> List[str]:
        sent = sent.lower() if opt["lowercase"] else sent
        return _BLEU_TOKENIZERS[tokenize](sent.rstrip()).split()

    sys_len = ref_len = 0
    correct, total = [0] * order, [0] * order
    for hyp, ref in zip(hypotheses, references):
        hyp_tokens, ref_tokens = prepare(hyp), prepare(ref)
        sys_len += len(hyp_tokens)
        ref_len += len(ref_tokens)
        ref_ngrams = _ngrams(ref_tokens, order)
        for ngram, count in _ngrams(hyp_tokens, order).items():
            total[len(ngram) - 1] += count
            correct[len(ngram) - 1] += min(count, ref_ngrams.get(ngram, 0))
    return _compute_bleu(correct, total, sys_len, ref_len, smooth_method,
                         opt["smooth_value"], opt["effective_order"], order)


def _compute_bleu(correct: List, total: List, sys_len: int, ref_len: int,
                  smooth_method: str, smooth_value: Optional[float],
                  effective_order: bool, max_order: int) -> float:
    """BLEU from its corpus statistics (sacrebleu ``BLEU.compute_bleu``)."""
    if smooth_value is None:
        smooth_value = _SMOOTH_DEFAULTS[smooth_method]
    bp = 1.0
    if sys_len < ref_len:
        bp = math.exp(1 - ref_len / sys_len) if sys_len > 0 else 0.0
    precisions = [0.0] * max_order
    if not any(correct):
        return 0.0
    smooth_mteval, eff_order = 1.0, max_order
    for n in range(1, max_order + 1):
        if smooth_method == "add-k" and n > 1:
            correct[n - 1] += smooth_value
            total[n - 1] += smooth_value
        if total[n - 1] == 0:
            break
        if effective_order:
            eff_order = n
        if correct[n - 1] == 0:
            if smooth_method == "exp":
                smooth_mteval *= 2
                precisions[n - 1] = 100.0 / (smooth_mteval * total[n - 1])
            elif smooth_method == "floor":
                precisions[n - 1] = 100.0 * smooth_value / total[n - 1]
        else:
            precisions[n - 1] = 100.0 * correct[n - 1] / total[n - 1]
    log_sum = sum(math.log(p) if p != 0.0 else -9999999999 for p in precisions[:eff_order])
    return bp * math.exp(log_sum / eff_order)


def _chrf_words(sent: str) -> List[str]:
    """Words with one punctuation mark split off their end or start
    (sacrebleu ``CHRF._remove_punctuation``)."""
    words = []
    for w in sent.split():
        if len(w) > 1 and w[-1] in _PUNCTS:
            words += [w[:-1], w[-1]]
        elif len(w) > 1 and w[0] in _PUNCTS:
            words += [w[0], w[1:]]
        else:
            words.append(w)
    return words


def _chrf_ngrams(sent: str, char_order: int, word_order: int,
                 whitespace: bool) -> List[Counter]:
    line = sent if whitespace else "".join(sent.split())
    out = [Counter(line[i:i + n] for i in range(len(line) - n + 1))
           for n in range(1, char_order + 1)]
    words = _chrf_words(sent) if word_order > 0 else []
    out += [Counter(" ".join(words[i:i + n]) for i in range(len(words) - n + 1))
            for n in range(1, word_order + 1)]
    return out


def _chrf_f_score(stats: List[int], order: int, beta: float, eps_smoothing: bool) -> float:
    """chrF in [0, 100] from [hyp, ref, match] counts per order
    (sacrebleu ``CHRF._compute_f_score``)."""
    eps, factor = 1e-16, beta ** 2
    score, effective_order, avg_prec, avg_rec = 0.0, 0, 0.0, 0.0
    for i in range(order):
        n_hyp, n_ref, n_match = stats[3 * i: 3 * i + 3]
        prec = n_match / n_hyp if n_hyp > 0 else eps
        rec = n_match / n_ref if n_ref > 0 else eps
        denom = factor * prec + rec
        score += ((1 + factor) * prec * rec / denom) if denom > 0 else eps
        if n_hyp > 0 and n_ref > 0:
            avg_prec += prec
            avg_rec += rec
            effective_order += 1
    if eps_smoothing:
        return 100 * score / order
    if effective_order == 0:
        avg_prec = avg_rec = 0.0
    else:
        avg_prec /= effective_order
        avg_rec /= effective_order
    if avg_prec + avg_rec:
        return 100 * ((1 + factor) * avg_prec * avg_rec) / ((factor * avg_prec) + avg_rec)
    return 0.0


def chrf(hypotheses: List[str], references: List[str], **sacrebleu_cfg) -> float:
    """Corpus chrF in [0, 1]: ``sacrebleu.metrics.CHRF(**cfg).corpus_score(
    hypotheses, [references]).score / 100`` (one reference each)."""
    opt = _options(sacrebleu_cfg, dict(char_order=6, word_order=0, beta=2, lowercase=False,
                                       whitespace=False, eps_smoothing=False))
    if len(hypotheses) != len(references):
        raise ValueError("hypotheses and references differ in number")
    order = opt["char_order"] + opt["word_order"]
    stats = [0] * (3 * order)
    for hyp, ref in zip(hypotheses, references):
        if opt["lowercase"]:
            hyp, ref = hyp.lower(), ref.lower()
        grams = [_chrf_ngrams(s, opt["char_order"], opt["word_order"], opt["whitespace"])
                 for s in (hyp, ref)]
        for i, (h, r) in enumerate(zip(*grams)):
            match = sum(min(count, r[ng]) for ng, count in h.items() if ng in r)
            stats[3 * i] += sum(h.values()) if r else 0
            stats[3 * i + 1] += sum(r.values())
            stats[3 * i + 2] += match
    return _chrf_f_score(stats, order, opt["beta"], opt["eps_smoothing"]) / 100


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
