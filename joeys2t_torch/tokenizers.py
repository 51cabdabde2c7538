# coding: utf-8
"""
Tokenizers (counterpart of joeys2t_tpu/tokenizers.py): ``BasicTokenizer``
:46 (word and char level), ``SentencePieceTokenizer`` :192,
``SubwordNMTTokenizer`` :253 and ``FastBPETokenizer`` :302 (``level: bpe``,
on the port's own ``spm`` and ``bpe`` modules, so no sentencepiece or
subword-nmt package is needed), ``SpeechProcessor`` :315,
``EvaluationTokenizer`` :371, ``_build_tokenizer`` :409 and
``build_tokenizer`` :442.

The text classes share one ``__call__``/``post_process`` skeleton;
subclasses plug in ``_segment`` (text -> pieces) and ``_join`` (pieces ->
text), and whether the ``<sep>`` prompt cut keeps the separator. Subword
sampling in training (SentencePiece ``alpha``, BPE ``dropout``) draws from
``rng``, a ``random.Random`` that each tokenizer owns, seeded with 42
(``rng.seed`` reseeds it); the JAX package draws from the global ``random``
module instead.

``pretokenizer: moses`` (joeys2t_tpu/tokenizers.py:65-80) runs the
``sacremoses`` package's punctuation normalizer (with ``normalize``) and
tokenizer on every raw line, and its detokenizer on the joined output:
a word-level hypothesis is detokenized from its pieces, a subword one
from its joined text (:96-97, :161, :231, :286). It needs ``sacremoses``
only when it is asked for.

``EvaluationTokenizer`` carries its own ``13a``, ``intl``, ``zh`` and
``none`` tokenizers, the behaviour of sacrebleu 2.x's, so the port needs no
sacrebleu: ``13a`` the mteval-v13a regexes; ``intl`` the mteval-v14
international rules (punctuation split off a non-digit neighbour, symbols
split off), over ``unicodedata``'s general categories where sacrebleu asks
the ``regex`` package for the classes P, S and N; ``zh``
every Chinese character spaced apart (sacrebleu's code-point ranges,
compared as it compares them) before the 13a regexes. ``ja-mecab`` needs
MeCab and raises ``NotImplementedError``.
"""
import random
import re
import shutil
import unicodedata
from pathlib import Path
from typing import Callable, Dict, List, Optional, Union

import numpy as np

from joeys2t_torch.bpe import BPE
from joeys2t_torch.config import ConfigurationError
from joeys2t_torch.data.audio_io import get_features
from joeys2t_torch.data.augmentation import CMVN, SpecAugment
from joeys2t_torch.helpers import remove_extra_spaces, remove_punctuation, unicode_normalize
from joeys2t_torch.spm import MiniSentencePiece
from joeys2t_torch.utils.logging import get_logger

logger = get_logger(__name__)

_SPACE = chr(32)  # ' '
_MARKER = chr(9601)  # '▁', the space escape of char-level and SentencePiece pieces


class BasicTokenizer:
    """Word- or char-level text tokenizer."""

    SPACE = _SPACE
    SPACE_ESCAPE = _MARKER
    # whether the prompt cut keeps the <sep> token (subword models keep it;
    # it is a special token, dropped with the others)
    _PROMPT_KEEPS_SEP = False

    def __init__(self, level: str = "word", lowercase: bool = False,
                 normalize: bool = False, max_length: int = -1,
                 min_length: int = -1, **kwargs):
        self.level = level
        self.lowercase = lowercase
        self.normalize = normalize
        self.max_length = max_length
        self.min_length = min_length
        self.rng = random.Random(42)
        self.pretokenizer = kwargs.get("pretokenizer", "none").lower()
        if self.pretokenizer not in ("none", "moses"):
            raise ConfigurationError("Currently, we support moses tokenizer only.")
        if self.pretokenizer == "moses":
            try:
                import sacremoses  # pylint: disable=import-outside-toplevel
            except ImportError as err:
                raise ImportError("pretokenizer: moses needs the sacremoses package") \
                    from err
            self.lang = kwargs.get("lang", "en")
            self.moses_tokenizer = sacremoses.MosesTokenizer(lang=self.lang)
            self.moses_detokenizer = sacremoses.MosesDetokenizer(lang=self.lang)
            if self.normalize:
                self.moses_normalizer = sacremoses.MosesPunctNormalizer()
        self.unk_token = self.eos_token = self.sep_token = None
        self.specials: List[str] = []
        self.lang_tags: List[str] = []

    def pre_process(self, raw_input: str, allow_empty: bool = False) -> str:
        """Clean one raw line: NFKC and space normalization, moses
        pretokenization, then lowercasing, in that order."""
        if not allow_empty and (not isinstance(raw_input, str) or not raw_input.strip()):
            raise ValueError("Got an empty input sentence; tokenization needs "
                             "non-empty text.")
        text = raw_input
        if self.normalize:
            text = remove_extra_spaces(unicode_normalize(text))
        if self.pretokenizer == "moses":
            if self.normalize:
                text = self.moses_normalizer.normalize(text)
            text = self.moses_tokenizer.tokenize(text, return_str=True)
        if self.lowercase:
            text = text.lower()
        if not allow_empty and not text:
            raise ValueError(f"{raw_input!r} is empty after pre-processing")
        return text

    def __call__(self, raw_input: Optional[str], is_train: bool = False
                 ) -> Optional[List[str]]:
        """Pieces of a clean line; in training, None when outside the length
        window."""
        if raw_input is None:
            return None
        pieces = self._segment(raw_input, is_train)
        if is_train and not self._length_ok(len(pieces)):
            return None
        return pieces

    def _segment(self, text: str, is_train: bool) -> List[str]:
        del is_train  # word and char segmentation draw nothing
        if self.level == "char":
            return list(text.replace(_SPACE, _MARKER))
        return text.split(_SPACE)

    def _length_ok(self, n: int) -> bool:
        """Train-time filter window; a bound <= 0 disables that side."""
        if self.max_length > 0 and n > self.max_length:
            return False
        return not (self.min_length > 0 and 0 < n < self.min_length)

    def post_process(self, sequence: Union[List[str], str], generate_unk: bool = True,
                     cut_at_sep: bool = True) -> str:
        """Detokenize decoder output: drop the forced prompt prefix, strip
        special tokens, rejoin to surface text. A hypothesis of SentencePiece
        space pieces alone comes out as the empty string, an empty
        transcript; the JAX package asserts there (joeys2t_tpu/tokenizers.py
        :140) and stops the run that decoded it."""
        if isinstance(sequence, list):
            if cut_at_sep and self.sep_token and self.sep_token in sequence:
                start = sequence.index(self.sep_token)
                sequence = sequence[start + (0 if self._PROMPT_KEEPS_SEP else 1):]
            banned = set(self.specials) | ({self.unk_token} if not generate_unk else set())
            sequence = self._join([p for p in sequence if p not in banned]
                                  or [self.unk_token])
        sequence = self._post_join(sequence)
        if self.normalize:
            sequence = remove_extra_spaces(sequence)
        return sequence

    def _join(self, pieces: List[str]) -> str:
        if self.level == "char":
            return "".join(pieces).replace(_MARKER, _SPACE)
        if self.pretokenizer == "moses":
            return self.moses_detokenizer.detokenize(pieces)
        return _SPACE.join(pieces)

    def _post_join(self, text: str) -> str:
        """Subword tokenizers detokenize the joined text (moses)."""
        return text

    def set_vocab(self, vocab) -> None:
        """Bind the special tokens' surface forms once the vocabulary
        exists."""
        self.unk_token = vocab.specials[vocab.unk_index]
        self.eos_token = vocab.specials[vocab.eos_index]
        self.sep_token = vocab.specials[vocab.sep_index] if vocab.sep_index else None
        reserved = vocab.specials + vocab.lang_tags
        self.specials = [t for t in reserved if t != self.unk_token]
        self.lang_tags = vocab.lang_tags

    def copy_cfg_file(self, model_dir: Path) -> None:
        """Word and char tokenizers have no model file to keep."""

    def _describe(self) -> str:
        return (f"level={self.level}, lowercase={self.lowercase}, "
                f"normalize={self.normalize}, "
                f"filter_by_length=({self.min_length}, {self.max_length}), "
                f"pretokenizer={self.pretokenizer}")

    def __repr__(self):
        return f"{self.__class__.__name__}({self._describe()})"


def _moses_detokenize(tokenizer: BasicTokenizer, text: str) -> str:
    """A subword tokenizer's joined text, moses-detokenized when it
    pretokenizes with moses."""
    if tokenizer.pretokenizer == "moses":
        return tokenizer.moses_detokenizer.detokenize(text.split())
    return text


class SentencePieceTokenizer(BasicTokenizer):
    """SentencePiece unigram or BPE pieces from a ``model_file``, read by the
    port's ``MiniSentencePiece``; with ``alpha`` > 0 training samples a
    segmentation (subword regularization)."""

    _PROMPT_KEEPS_SEP = True

    def __init__(self, level: str = "bpe", lowercase: bool = False,
                 normalize: bool = False, max_length: int = -1,
                 min_length: int = -1, **kwargs):
        super().__init__(level, lowercase, normalize, max_length, min_length, **kwargs)
        if self.level != "bpe":
            raise ConfigurationError(f"SentencePiece takes level bpe, not {self.level}")
        self.model_file = Path(kwargs["model_file"])
        if not self.model_file.is_file():
            raise FileNotFoundError(f"model file {self.model_file} not found.")
        self.spm = MiniSentencePiece.from_file(self.model_file, rng=self.rng)
        self.nbest_size: int = kwargs.get("nbest_size", 5)
        self.alpha: float = kwargs.get("alpha", 0.0)

    def _segment(self, text: str, is_train: bool) -> List[str]:
        if is_train and self.alpha > 0:
            return self.spm.sample_encode_as_pieces(text, nbest_size=self.nbest_size,
                                                    alpha=self.alpha)
        return self.spm.encode(text, out_type=str)

    def _join(self, pieces: List[str]) -> str:
        return self.spm.decode(pieces).replace(_MARKER, _SPACE).strip()

    def _post_join(self, text: str) -> str:
        return _moses_detokenize(self, text)

    def set_vocab(self, vocab) -> None:
        super().set_vocab(vocab)
        self.spm.SetVocabulary(vocab._tokens)  # pylint: disable=protected-access

    def copy_cfg_file(self, model_dir: Path) -> None:
        """Keep the SentencePiece model beside the config in ``model_dir``."""
        dest = Path(model_dir) / self.model_file.name
        if dest.is_file():
            logger.warning("%s already exists. Stop copying.", dest.as_posix())
            return
        shutil.copy2(self.model_file, dest.as_posix())

    def __repr__(self):
        return (f"{self.__class__.__name__}({self._describe()}, "
                f"tokenizer={self.spm.__class__.__name__}, "
                f"nbest_size={self.nbest_size}, alpha={self.alpha})")


class SubwordNMTTokenizer(BasicTokenizer):
    """subword-nmt BPE from a ``codes`` file through the port's ``bpe``
    module; ``dropout`` applies in training, ``glossaries`` stay whole."""

    _PROMPT_KEEPS_SEP = True

    def __init__(self, level: str = "bpe", lowercase: bool = False,
                 normalize: bool = False, max_length: int = -1,
                 min_length: int = -1, **kwargs):
        super().__init__(level, lowercase, normalize, max_length, min_length, **kwargs)
        if self.level != "bpe":
            raise ConfigurationError(f"subword-nmt takes level bpe, not {self.level}")
        self.codes = Path(kwargs["codes"])
        if not self.codes.is_file():
            raise FileNotFoundError(f"codes file {self.codes} not found.")
        self.separator: str = kwargs.get("separator", "@@")
        self.dropout: float = kwargs.get("dropout", 0.0)
        self.bpe = BPE.from_file(self.codes, separator=self.separator, rng=self.rng)
        self.bpe.glossaries = list(kwargs.get("glossaries") or [])

    def _segment(self, text: str, is_train: bool) -> List[str]:
        dropout = self.dropout if is_train else 0.0
        return self.bpe.process_line(text, dropout).strip().split()

    def _join(self, pieces: List[str]) -> str:
        text = _SPACE.join(pieces).replace(self.separator + _SPACE, "")
        return text[:-len(self.separator)] if text.endswith(self.separator) else text

    def _post_join(self, text: str) -> str:
        return _moses_detokenize(self, text)

    def set_vocab(self, vocab) -> None:
        super().set_vocab(vocab)
        self.bpe.vocab = (set(vocab._tokens)  # pylint: disable=protected-access
                          - set(vocab.specials) - set(vocab.lang_tags))

    def copy_cfg_file(self, model_dir: Path) -> None:
        """Keep the codes file beside the config in ``model_dir``."""
        shutil.copy2(self.codes, (Path(model_dir) / self.codes.name).as_posix())

    def __repr__(self):
        return (f"{self.__class__.__name__}({self._describe()}, "
                f"separator={self.separator}, dropout={self.dropout})")


class FastBPETokenizer(SubwordNMTTokenizer):
    """fastBPE codes, which have subword-nmt's format: the separator '@@'
    and no dropout."""

    def __init__(self, level: str = "bpe", lowercase: bool = False,
                 normalize: bool = False, max_length: int = -1,
                 min_length: int = -1, **kwargs):
        kwargs.setdefault("separator", "@@")
        super().__init__(level, lowercase, normalize, max_length, min_length, **kwargs)
        self.dropout = 0.0


class SpeechProcessor:
    """Feature lookup, length filter and truncation, CMVN and SpecAugment
    for one speech entry."""

    def __init__(self, level: str = "frame", num_freq: int = 80,
                 normalize: bool = False, max_length: int = -1,
                 min_length: int = -1, **kwargs):
        self.level = level
        self.num_freq = num_freq
        self.normalize = normalize
        self.max_length = max_length
        self.min_length = min_length
        self.specaugment: Optional[Callable] = (
            SpecAugment(**kwargs["specaugment"]) if "specaugment" in kwargs else None)
        self.cmvn: Optional[CMVN] = CMVN(**kwargs["cmvn"]) if "cmvn" in kwargs else None
        self.root_path = ""  # set by the dataset

    def __call__(self, line: str, is_train: bool = False) -> Optional[np.ndarray]:
        """(frames, num_freq) features, or None when filtered. Too short
        utterances are dropped even at test time (the subsampler cannot
        convolve them); too long ones are dropped in training and truncated
        otherwise. CMVN runs before or after SpecAugment as its ``before``
        flag says."""
        feats = get_features(self.root_path, line)
        n_frames = feats.shape[0]
        if feats.shape[1] != self.num_freq:
            raise ValueError(f"{line}: {feats.shape[1]} features, expected "
                             f"{self.num_freq}")
        if 0 < n_frames < self.min_length:
            return None
        if self.max_length > 0 and n_frames > self.max_length:
            if is_train:
                return None
            feats = feats[:self.max_length, :]
        if self.cmvn and self.cmvn.before:
            feats = self.cmvn(feats)
        if is_train and self.specaugment:
            feats = self.specaugment(feats)
        if self.cmvn and not self.cmvn.before:
            feats = self.cmvn(feats)
        return feats

    def set_vocab(self, vocab) -> None:
        """Features have no vocabulary."""

    def copy_cfg_file(self, model_dir: Path) -> None:
        """Nothing to keep."""

    def __repr__(self):
        return (f"{self.__class__.__name__}(level={self.level}, "
                f"normalize={self.normalize}, "
                f"filter_by_length=({self.min_length}, {self.max_length}), "
                f"cmvn={self.cmvn}, specaugment={self.specaugment})")


# the regexes of sacrebleu's 13a tokenizer (mteval-v13a): symbols, then
# period and comma unless both neighbours are digits, then a dash after a digit
_13A_RULES = [
    (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
    (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
    (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
    (re.compile(r"([0-9])(-)"), r"\1 \2 "),
]


def tokenize_13a(line: str) -> str:
    """sacrebleu's ``13a`` tokenization of one line."""
    line = line.replace("<skipped>", "").replace("-\n", "").replace("\n", " ")
    if "&" in line:
        line = (line.replace("&quot;", '"').replace("&amp;", "&")
                .replace("&lt;", "<").replace("&gt;", ">"))
    return _post_13a(f" {line} ")


def _post_13a(line: str) -> str:
    """sacrebleu's ``TokenizerRegexp``: the 13a regexes, single spaces."""
    for rule, repl in _13A_RULES:
        line = rule.sub(repl, line)
    return " ".join(line.split())


def _split_pairs(line: str, hit: Callable[[str, str], bool], repl: str) -> str:
    """``re.sub`` of a two-character pattern ``(a)(b)`` that ``hit``
    accepts, with ``repl`` over ``{a}`` and ``{b}``: scanned left to right,
    matches do not overlap."""
    out, i = [], 0
    while i < len(line):
        if i + 1 < len(line) and hit(line[i], line[i + 1]):
            out.append(repl.format(a=line[i], b=line[i + 1]))
            i += 2
        else:
            out.append(line[i])
            i += 1
    return "".join(out)


def _category(ch: str) -> str:
    return unicodedata.category(ch)[0]


def tokenize_intl(line: str) -> str:
    """sacrebleu's ``intl`` tokenization (mteval-v14's international
    rules) of one line."""
    line = _split_pairs(line, lambda a, b: _category(a) != "N" and _category(b) == "P",
                        "{a} {b} ")
    line = _split_pairs(line, lambda a, b: _category(a) == "P" and _category(b) != "N",
                        " {a} {b}")
    line = "".join(f" {ch} " if _category(ch) == "S" else ch for ch in line)
    return " ".join(line.split())


# sacrebleu's Chinese ranges as it writes them: two of the bounds are two
# characters long ("\u20000" is U+2000 then "0"), and a character counts
# when it compares between the strings
_ZH_RANGES = [
    ("\u3400", "\u4db5"), ("\u4e00", "\u9fa5"), ("\u9fa6", "\u9fbb"), ("\uf900", "\ufa2d"),
    ("\ufa30", "\ufa6a"), ("\ufa70", "\ufad9"), ("\u20000", "\u2a6d6"),
    ("\u2f800", "\u2fa1d"), ("\uff00", "\uffef"), ("\u2e80", "\u2eff"), ("\u3000", "\u303f"),
    ("\u31c0", "\u31ef"), ("\u2f00", "\u2fdf"), ("\u2ff0", "\u2fff"), ("\u3100", "\u312f"),
    ("\u31a0", "\u31bf"), ("\ufe10", "\ufe1f"), ("\ufe30", "\ufe4f"), ("\u2600", "\u26ff"),
    ("\u2700", "\u27bf"), ("\u3200", "\u32ff"), ("\u3300", "\u33ff"),
]


def tokenize_zh(line: str) -> str:
    """sacrebleu's ``zh`` tokenization of one line: each Chinese character
    spaced apart, then the 13a regexes."""
    spaced = "".join(f" {ch} " if any(lo <= ch <= hi for lo, hi in _ZH_RANGES) else ch
                     for ch in line.strip())
    return _post_13a(spaced)


_EVAL_TOKENIZERS = {"13a": tokenize_13a, "intl": tokenize_intl, "zh": tokenize_zh,
                    "none": lambda line: line}


class EvaluationTokenizer(BasicTokenizer):
    """Evaluation tokenization for WER: ``13a``, ``intl``, ``zh`` or
    ``none``, then optional lowercasing and removal of punctuation-only
    tokens."""

    ALL_TOKENIZER_TYPES = ["none", "13a", "intl", "zh", "ja-mecab"]

    def __init__(self, lowercase: bool = False, tokenize: str = "13a", **kwargs):
        super().__init__(level="word", lowercase=lowercase, normalize=False,
                         max_length=-1, min_length=-1)
        if tokenize not in self.ALL_TOKENIZER_TYPES:
            raise ConfigurationError(f"`{tokenize}` not supported.")
        if tokenize not in _EVAL_TOKENIZERS:
            raise NotImplementedError(f"the `{tokenize}` evaluation tokenizer is not "
                                      f"ported: it needs MeCab")
        self.tokenize = tokenize
        self.tokenizer = _EVAL_TOKENIZERS[tokenize]
        self.no_punc = kwargs.get("no_punc", False)

    def __call__(self, raw_input: str, is_train: bool = False) -> List[str]:
        text = self.tokenizer(raw_input)
        if self.lowercase:
            text = text.lower()
        if self.no_punc:
            text = remove_punctuation(text, space=_SPACE)
        return text.split()

    def __repr__(self):
        return (f"{self.__class__.__name__}(level={self.level}, "
                f"lowercase={self.lowercase}, tokenizer={self.tokenize}, "
                f"no_punc={self.no_punc})")


_BPE_BACKENDS = {
    "sentencepiece": (SentencePieceTokenizer, "model_file"),
    "subword-nmt": (SubwordNMTTokenizer, "codes"),
    "fastbpe": (FastBPETokenizer, "codes"),
}


def _build_tokenizer(cfg: Dict):
    """One side's tokenizer from its data-config section."""
    level = cfg["level"]
    extra = cfg.get("tokenizer_cfg", {})
    if extra.get("pretokenizer", "none") == "moses":  # moses takes the side's language
        extra = dict(extra, lang=cfg["lang"])
    common = dict(level=level, lowercase=cfg.get("lowercase", False),
                  normalize=cfg.get("normalize", False),
                  max_length=cfg.get("max_length", -1),
                  min_length=cfg.get("min_length", -1))
    if level in ("word", "char"):
        return BasicTokenizer(**common, **extra)
    if level == "bpe":
        backend = cfg.get("tokenizer_type", cfg.get("bpe_type", "sentencepiece"))
        if backend not in _BPE_BACKENDS:
            raise ConfigurationError(f"{backend}: Unknown tokenizer type. "
                                     "Valid options: {'sentencepiece', 'subword-nmt'}.")
        cls, required_key = _BPE_BACKENDS[backend]
        if required_key not in extra:
            raise ConfigurationError(f"{backend} needs `{required_key}` in tokenizer_cfg")
        return cls(**common, **extra)
    if level == "frame":
        return SpeechProcessor(num_freq=cfg["num_freq"], **common, **extra)
    raise ConfigurationError(f"{level}: Unknown tokenization level. "
                             "Valid options: {'word', 'bpe', 'char'}.")


def build_tokenizer(cfg: Dict, task: str) -> Dict:
    """Both sides' tokenizers keyed by language (``src``/``trg`` for S2T)."""
    src_lang = cfg["src"]["lang"] if task == "MT" else "src"
    trg_lang = cfg["trg"]["lang"] if task == "MT" else "trg"
    tokenizer = {src_lang: _build_tokenizer(cfg["src"]),
                 trg_lang: _build_tokenizer(cfg["trg"])}
    logger.info("%s Tokenizer: %s", src_lang, tokenizer[src_lang])
    logger.info("%s Tokenizer: %s", trg_lang, tokenizer[trg_lang])
    return tokenizer
