# coding: utf-8
"""
Datasets (counterpart of joeys2t_tpu/data/datasets.py): ``BaseDataset`` :54
with ``collate_fn`` :172 and ``make_iter`` :207, ``_BatchIterator`` :270,
``_prefetch`` :291, ``PlaintextDataset`` :312, ``TsvDataset`` :360, ``SpeechDataset`` :420,
``StreamDataset`` :481, ``SpeechStreamDataset`` :542,
``BaseHuggingfaceDataset`` :574, ``HuggingfaceTranslationDataset`` :648,
``build_dataset`` :676.

Manifests are read with the ``csv`` module under the semantics of the JAX
package's pandas reads. A speech manifest (:442): tab separated, a header
row, no quoting, ``\\`` escapes the next character, no NA filtering, every
column a string but ``n_frames``; rows whose ``n_frames`` is not above the
source ``min_length`` or with a blank field are dropped (:449-450). A text
TSV (:379): tab separated, a header row, ``"`` quoting, and rows with a
missing or NA field dropped. A Huggingface dataset (the ``datasets``
package, imported only for one) is read with ``load_from_disk`` when its
path holds a saved dataset and ``load_dataset`` otherwise; its split is
``dataset_cfg.split`` (``hf_split``), else the positional one with dev read
as ``validation``.
"""
import csv
import queue
import re
import threading
from functools import partial
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from joeys2t_torch.config import ConfigurationError
from joeys2t_torch.data.batch import Batch
from joeys2t_torch.data.samplers import (RandomSubsetSampler, SentenceBatchSampler,
                                         ShardedSubsetSampler, TokenBatchSampler)
from joeys2t_torch.parallel import distributed
from joeys2t_torch.helpers import read_list_from_file
from joeys2t_torch.tokenizers import SpeechProcessor
from joeys2t_torch.utils.logging import get_logger

logger = get_logger(__name__)

# pandas' default NA strings, which its read_csv drops for text TSVs
_PANDAS_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
              "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
              "nan", "null"}
_BLANK = re.compile(r"\s*")


def _read_tsv(path: Path, **fmt) -> Tuple[List[str], List[List[str]]]:
    """(header, rows) of a tab-separated file; blank lines are skipped, short
    rows are padded with empty fields and long rows raise."""
    with path.open("r", encoding="utf-8", newline="") as f:
        lines = [r for r in csv.reader(f, delimiter="\t", **fmt) if r]
    if not lines:
        raise ValueError(f"{path}: empty file")
    header, rows = lines[0], []
    for n, row in enumerate(lines[1:], 2):
        if len(row) > len(header):
            raise ValueError(f"{path}: expected {len(header)} fields in row {n}, "
                             f"saw {len(row)}")
        rows.append(row + [""] * (len(header) - len(row)))
    return header, rows


def _strip_tag_escape(pieces, tok):
    """Drop a stray leading space escape before a language tag."""
    if (pieces is not None and tok is not None and len(pieces) > 1
            and pieces[0] == tok.SPACE_ESCAPE and pieces[1] in tok.lang_tags):
        return pieces[1:]
    return pieces


class BaseDataset:
    """Tokenizers, sequence encoders, subset indices and prompts of one
    split (behaviour of joeynmt/datasets.py:28-335)."""

    # pylint: disable=too-many-instance-attributes

    def __init__(self, path: Optional[str], src_lang: str, trg_lang: str,
                 split: str = "train", has_trg: bool = False,
                 has_prompt: Optional[Dict[str, bool]] = None,
                 tokenizer: Optional[Dict] = None,
                 sequence_encoder: Optional[Dict[str, Callable]] = None,
                 random_subset: int = -1, task: str = "MT"):
        self.path, self.split, self.task = path, split, task
        self.src_lang, self.trg_lang = src_lang, trg_lang
        self.has_trg = has_trg
        if not has_trg and split == "train":
            raise ValueError("a training set needs targets")
        self.tokenizer = tokenizer
        self.sequence_encoder = sequence_encoder
        self.has_prompt = has_prompt
        langs = (src_lang, trg_lang) if has_trg else (src_lang,)
        for table in (self.tokenizer, self.sequence_encoder, self.has_prompt):
            missing = [lang for lang in langs if lang not in table]
            if missing:
                raise ValueError(f"no entry for {missing} in {table}")
        self.random_subset = random_subset
        # `indices` drives every sampler; subsampling replaces it with a
        # sorted subset, order randomness lives in the samplers
        self.indices: Optional[List[int]] = None
        self.seed = 1
        self.trg_vocab = None  # set by load_data; predict decodes ids with it

    def reset_indices(self, random_subset: Optional[int] = None) -> None:
        n = len(self)
        self.indices = list(range(n))
        if random_subset is not None:
            self.random_subset = random_subset
        if self.random_subset > 0 and (self.split == "test" or self.random_subset >= n):
            raise ValueError(f"random_subset={self.random_subset} needs a train/dev "
                             f"set with more than that many examples (got {n}).")

    def get_item(self, idx: int, lang: str, is_train: Optional[bool] = None):
        """Tokenize one item; with a prompt, ``prompt <sep> item``, the prompt
        truncated to fit the tokenizer's ``max_length``."""
        if is_train is None:
            is_train = self.split == "train"
        tok = self.tokenizer[lang]
        line, prompt = self.lookup_item(idx, lang)
        item = _strip_tag_escape(tok(line, is_train=is_train), tok)
        if self.has_prompt[lang] and prompt is not None:
            prompt = _strip_tag_escape(tok(prompt, is_train=False), tok)
            item = item or []
            limit = tok.max_length
            if 0 < limit < len(prompt) + 1 + len(item):
                keep = limit - 1 - len(item)  # prompt tokens that still fit
                if prompt[0] in tok.lang_tags:
                    prompt = [prompt[0]] + prompt[-(keep - 1):]
                else:
                    prompt = prompt[-keep:]
            item = prompt + [tok.sep_token] + item
        return item

    def lookup_item(self, idx: int, lang: str) -> Tuple[str, Optional[str]]:
        raise NotImplementedError

    def _src_example(self, idx: int):
        """The source side of one example (speech datasets run the
        SpeechProcessor instead)."""
        return self.get_item(idx=idx, lang=self.src_lang)

    def __getitem__(self, idx: int) -> Tuple[int, Any, Any]:
        if idx >= len(self):
            raise KeyError(idx)
        src = self._src_example(idx)
        trg = None
        # a filtered-out target drops the whole pair (src None marks it)
        if self.has_trg or self.has_prompt[self.trg_lang]:
            trg = self.get_item(idx=idx, lang=self.trg_lang)
            if trg is None:
                src = None
        return idx, src, trg

    def get_list(self, lang: str, tokenized: bool = False, subsampled: bool = True):
        raise NotImplementedError

    @property
    def src(self) -> List[str]:
        return self.get_list(self.src_lang)

    @property
    def trg(self) -> List[str]:
        return self.get_list(self.trg_lang) if self.has_trg else []

    def collate_fn(self, batch: List[Tuple], pad_index: int, eos_index: int) -> Batch:
        """Examples -> a host ``Batch`` (joeynmt/datasets.py:186-242)."""
        idx, src_list, trg_list = zip(*batch)
        src, src_length, src_prompt_mask = self.sequence_encoder[self.src_lang](src_list)
        if self.has_trg or self.has_prompt[self.trg_lang]:
            trg, trg_length, trg_prompt_mask = self.sequence_encoder[self.trg_lang](
                trg_list, bos=True, eos=self.has_trg)  # no eos without references
        else:
            trg, trg_length, trg_prompt_mask = None, None, None
        return Batch(
            src=(np.asarray(src, dtype=np.int32) if self.task == "MT"
                 else np.asarray(src, dtype=np.float32)),
            src_length=np.asarray(src_length, dtype=np.int32),
            src_prompt_mask=(np.asarray(src_prompt_mask, dtype=np.int32)
                             if self.has_prompt[self.src_lang] else None),
            trg=np.asarray(trg, dtype=np.int32) if trg is not None else None,
            trg_length=(np.asarray(trg_length, dtype=np.int32)
                        if trg_length is not None else None),
            trg_prompt_mask=(np.asarray(trg_prompt_mask, dtype=np.int32)
                             if self.has_prompt[self.trg_lang] else None),
            indices=np.asarray(idx, dtype=np.int32),
            pad_index=pad_index, eos_index=eos_index,
            is_train=self.split == "train", task=self.task)

    def make_iter(self, batch_size: int, batch_type: str = "sentence", seed: int = 42,
                  shuffle: bool = False, num_workers: int = 0, pad_index: int = 1,
                  eos_index: int = 3, generator_state=None, return_sampler: bool = False):
        """The (re-iterable batch iterator[, batch sampler]) pipeline
        (joeynmt/datasets.py:244-323); ``num_workers > 0`` reads ahead on a
        background thread. In a data-parallel run the training set is
        sharded rank-strided (``ShardedSubsetSampler``, JAX :232), and each
        rank makes batches of ``batch_size`` from its own share; evaluation
        sets are batched alike on every rank, and ``predict`` shares their
        batches out."""
        shuffle = shuffle and self.split == "train"
        if self.split == "train" and distributed.in_group():
            sampler = ShardedSubsetSampler(self, shuffle=shuffle, seed=seed)
        else:
            sampler = RandomSubsetSampler(self, shuffle=shuffle, seed=seed)
        if batch_type == "sentence":
            batch_sampler = SentenceBatchSampler(sampler, batch_size=batch_size,
                                                 drop_last=False, seed=seed)
        elif batch_type == "token":
            batch_sampler = TokenBatchSampler(sampler, batch_size=batch_size,
                                              drop_last=False, seed=seed)
        else:
            raise ConfigurationError(f"{batch_type}: Unknown batch type")
        batch_sampler.set_seed(seed)
        if generator_state is not None:
            batch_sampler.set_state(generator_state)
        collate = partial(self.collate_fn, eos_index=eos_index, pad_index=pad_index)
        iterator = _BatchIterator(self, batch_sampler, collate, num_workers)
        return (iterator, batch_sampler) if return_sampler else iterator

    def __len__(self) -> int:
        raise NotImplementedError

    def __repr__(self) -> str:
        return (f"{self.__class__.__name__}(split={self.split}, len={len(self)}, "
                f'src_lang="{self.src_lang}", trg_lang="{self.trg_lang}", '
                f"has_trg={self.has_trg}, random_subset={self.random_subset}, "
                f"has_src_prompt={self.has_prompt[self.src_lang]}, "
                f"has_trg_prompt={self.has_prompt[self.trg_lang]})")


class _BatchIterator:
    """Re-iterable batch pipeline: each ``__iter__`` replays the batch
    sampler, so an epoch loop can go over it again."""

    def __init__(self, dataset, batch_sampler, collate, num_workers: int):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate = collate
        self.num_workers = num_workers

    def __iter__(self) -> Iterator[Batch]:
        gen = (self.collate([self.dataset[i] for i in index_batch])
               for index_batch in self.batch_sampler)
        if self.num_workers > 0:
            return _prefetch(gen, self.num_workers, "batch-prefetch")
        return gen


def _prefetch(it: Iterator, depth: int = 2, name: str = "prefetch") -> Iterator:
    """Run ``it`` ahead on a daemon thread through a bounded queue. An
    exception of the worker is raised on the consuming side; closing the
    returned generator stops the worker."""
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    return
            put(end)
        except BaseException as e:  # pylint: disable=broad-except
            put(e)  # raised on the consuming side

    thread = threading.Thread(target=worker, daemon=True, name=name)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


class PlaintextDataset(BaseDataset):
    """One sentence a line in ``<path>.<src_lang>`` and ``<path>.<trg_lang>``
    (the target file optional outside training), each non-empty line
    pre-processed by its side's tokenizer. A ``<path>.<lang>_prompt`` file,
    one prompt a line (empty for none), switches prompting on for that side,
    as a ``<lang>_prompt`` column does in a TSV; the JAX package's plaintext
    reader has no such files."""

    def __init__(self, path, src_lang, trg_lang, split="train", has_trg=True,
                 has_prompt=None, tokenizer=None, sequence_encoder=None,
                 random_subset=-1, task="MT", **kwargs):
        super().__init__(path=path, src_lang=src_lang, trg_lang=trg_lang, split=split,
                         has_trg=has_trg, has_prompt=has_prompt, tokenizer=tokenizer,
                         sequence_encoder=sequence_encoder,
                         random_subset=random_subset, task=task)
        self.data = self.load_data(path, **kwargs)
        self.reset_indices()

    def load_data(self, path, **kwargs) -> Dict[str, List[str]]:
        base = Path(path)
        sides = [self.src_lang] + ([self.trg_lang] if self.has_trg else [])
        data, counts = {}, []
        for lang in sides:
            side_file = base.with_suffix(f"{base.suffix}.{lang}")
            if not side_file.is_file():
                raise FileNotFoundError(f"{side_file} not found. Abort.")
            lines = read_list_from_file(side_file)
            counts.append(len(lines))
            data[lang] = [self.tokenizer[lang].pre_process(line) for line in lines
                          if len(line) > 0]
        for lang in (self.src_lang, self.trg_lang):
            prompt_file = base.with_suffix(f"{base.suffix}.{lang}_prompt")
            if prompt_file.is_file():
                lines = read_list_from_file(prompt_file)
                counts.append(len(lines))
                self.has_prompt[lang] = True
                data[f"{lang}_prompt"] = [
                    self.tokenizer[lang].pre_process(line, allow_empty=True) or None
                    for line in lines]
        if len(set(counts)) != 1:
            raise ValueError(f"{path}: the sides' line counts differ: {counts}")
        return data

    def lookup_item(self, idx: int, lang: str) -> Tuple[str, Optional[str]]:
        prompts = self.data.get(f"{lang}_prompt")
        return self.data[lang][idx], None if prompts is None else prompts[idx]

    def get_list(self, lang, tokenized=False, subsampled=True):
        rows = self.indices if subsampled else range(len(self))
        lines = [self.data[lang][i] for i in rows]
        if tokenized:
            return [self.tokenizer[lang](line, is_train=False) for line in lines]
        return lines

    def __len__(self) -> int:
        return len(self.data[self.src_lang])


class TsvDataset(BaseDataset):
    """TSV with ``src_lang`` / ``trg_lang`` header columns and optional
    ``<lang>_prompt`` columns."""

    def __init__(self, path, src_lang, trg_lang, split="train", has_trg=True,
                 has_prompt=None, tokenizer=None, sequence_encoder=None,
                 random_subset=-1, task="MT", **kwargs):
        super().__init__(path=path, src_lang=src_lang, trg_lang=trg_lang, split=split,
                         has_trg=has_trg, has_prompt=has_prompt, tokenizer=tokenizer,
                         sequence_encoder=sequence_encoder,
                         random_subset=random_subset, task=task)
        self.rows = self.load_data(path, **kwargs)
        self.reset_indices()

    def _tsv_path(self, path) -> Path:
        base = Path(path)
        tsv = base.with_suffix(f"{base.suffix}.tsv")
        if not tsv.is_file():
            raise FileNotFoundError(f"{tsv} not found. Abort.")
        return tsv

    def load_data(self, path, **kwargs) -> List[Dict[str, str]]:
        tsv = self._tsv_path(path)
        header, raw = _read_tsv(tsv)
        rows = [dict(zip(header, r)) for r in raw
                if not any(v in _PANDAS_NA for v in r)]
        if self.src_lang not in header:
            raise ValueError(f"{tsv}: missing the {self.src_lang} column")
        # a reference-less tsv is only legal for test-time decoding
        if self.trg_lang not in header:
            if self.split != "test":
                raise ValueError(f"{tsv}: {self.trg_lang} column required outside test")
            self.has_trg = False
        sides = [self.src_lang] + ([self.trg_lang] if self.has_trg else [])
        self._clean(rows, header, sides)
        return rows

    def _clean(self, rows, header, sides) -> None:
        """Pre-process the text columns; a ``<lang>_prompt`` column switches
        prompting on for its side."""
        for lang in sides:
            for r in rows:
                r[lang] = self.tokenizer[lang].pre_process(r[lang])
        for lang in (self.src_lang, self.trg_lang):
            col = f"{lang}_prompt"
            if col in header:
                self.has_prompt[lang] = True
                for r in rows:
                    r[col] = self.tokenizer[lang].pre_process(r[col], allow_empty=True)

    def lookup_item(self, idx: int, lang: str) -> Tuple[str, Optional[str]]:
        row = self.rows[idx]
        return row[lang], row.get(f"{lang}_prompt", None)

    def get_list(self, lang, tokenized=False, subsampled=True):
        indices = self.indices if subsampled else range(len(self))
        lines = [self.rows[i][lang] for i in indices]
        if tokenized:
            return [self.tokenizer[lang](line) for line in lines]
        return lines

    def __len__(self) -> int:
        return len(self.rows)


class SpeechDataset(TsvDataset):
    """Speech manifest ``id | src | n_frames | trg``: ``src`` holds feature
    paths that the SpeechProcessor resolves against the manifest's folder."""

    def __init__(self, path, src_lang="src", trg_lang="trg", split="train",
                 has_trg=True, has_prompt=None, tokenizer=None,
                 sequence_encoder=None, random_subset=-1, task="S2T", **kwargs):
        BaseDataset.__init__(self, path=path, src_lang=src_lang, trg_lang=trg_lang,
                             split=split, has_trg=has_trg, has_prompt=has_prompt,
                             tokenizer=tokenizer, sequence_encoder=sequence_encoder,
                             random_subset=random_subset, task=task)
        if not isinstance(self.tokenizer["src"], SpeechProcessor):
            raise ValueError("a speech dataset needs a SpeechProcessor for src")
        self.rows = self.load_data(path, **kwargs)
        self.tokenizer["src"].root_path = Path(path).parent
        self.reset_indices()

    def load_data(self, path, **kwargs) -> List[Dict[str, Any]]:
        tsv = self._tsv_path(path)
        header, raw = _read_tsv(tsv, quoting=csv.QUOTE_NONE, escapechar="\\")
        if "src" not in header:
            raise ValueError(f"{tsv}: missing the src column")
        min_frames = int(self.tokenizer["src"].min_length)
        rows = []
        for r in raw:
            row: Dict[str, Any] = dict(zip(header, r))
            if "n_frames" in row:
                row["n_frames"] = int(row["n_frames"])
                if row["n_frames"] <= min_frames:  # cannot be convolved
                    continue
            if any(isinstance(v, str) and _BLANK.fullmatch(v) for v in row.values()):
                continue
            rows.append(row)
        # audio manifests never carry a src prompt; one without transcripts
        # is only legal at test time
        self.has_prompt["src"] = False
        if "trg" not in header:
            if self.split != "test":
                raise ValueError(f"{tsv}: trg column required outside test")
            self.has_trg = False
        self._clean(rows, header, ["trg"] if self.has_trg else [])
        return rows

    def _src_example(self, idx: int):
        feature_path, _ = self.lookup_item(idx=idx, lang="src")
        return self.tokenizer["src"](feature_path, is_train=self.split == "train")

    @property
    def src(self) -> List[str]:
        return [r["src"] for r in self.rows]


class StreamDataset(BaseDataset):
    """Interactive or stdin input for translate mode."""

    def __init__(self, path, src_lang, trg_lang, split="test", has_trg=False,
                 has_prompt=None, tokenizer=None, sequence_encoder=None,
                 random_subset=-1, task="MT", **kwargs):
        super().__init__(path=path, src_lang=src_lang, trg_lang=trg_lang, split=split,
                         has_trg=has_trg, has_prompt=has_prompt, tokenizer=tokenizer,
                         sequence_encoder=sequence_encoder,
                         random_subset=random_subset, task=task)
        self.cache: List[Tuple] = []

    def _split_at_sep(self, line, prompt, lang: str, sep_token):
        """An inline ``<prompt> <sep> <text>`` input splits into its two parts
        unless a prompt was given."""
        if prompt is None and sep_token is not None and line is not None \
                and sep_token in line:
            line, prompt = line.split(sep_token)
        clean = self.tokenizer[lang].pre_process
        line = clean(line, allow_empty=False) if line else line
        if prompt:
            prompt = clean(prompt, allow_empty=True)
            self.has_prompt[lang] = True
        return line, prompt

    def set_item(self, src_line: str, trg_line: Optional[str] = None,
                 src_prompt: Optional[str] = None,
                 trg_prompt: Optional[str] = None) -> None:
        if not isinstance(src_line, str) or not src_line.strip():
            raise ValueError("Got an empty input sentence; tokenization needs "
                             "non-empty text.")
        src_line, src_prompt = self._split_at_sep(
            src_line, src_prompt, self.src_lang,
            getattr(self.tokenizer[self.src_lang], "sep_token", None))
        trg_line, trg_prompt = self._split_at_sep(
            trg_line, trg_prompt, self.trg_lang,
            getattr(self.tokenizer[self.trg_lang], "sep_token", None))
        self.cache.append((src_line, trg_line, src_prompt, trg_prompt))
        self.reset_indices()

    def lookup_item(self, idx: int, lang: str) -> Tuple[str, Optional[str]]:
        src_line, trg_line, src_prompt, trg_prompt = self.cache[idx]
        if lang == self.src_lang:
            return src_line, src_prompt
        return trg_line, trg_prompt

    def reset_cache(self) -> None:
        self.cache = []
        self.reset_indices()

    def __len__(self) -> int:
        return len(self.cache)


class SpeechStreamDataset(StreamDataset):
    """Audio file paths as translate-mode input."""

    def __init__(self, path, src_lang="src", trg_lang="trg", split="test",
                 has_trg=False, has_prompt=None, tokenizer=None,
                 sequence_encoder=None, random_subset=-1, task="S2T", **kwargs):
        super().__init__(path=path, src_lang=src_lang, trg_lang=trg_lang, split=split,
                         has_trg=has_trg, has_prompt=has_prompt, tokenizer=tokenizer,
                         sequence_encoder=sequence_encoder,
                         random_subset=random_subset, task=task)
        self.has_prompt["src"] = False
        if not isinstance(self.tokenizer["src"], SpeechProcessor):
            raise ValueError("a speech stream needs a SpeechProcessor for src")
        self.tokenizer["src"].root_path = Path("")

    def set_item(self, src_line: str, trg_line: Optional[str] = None,
                 src_prompt: Optional[str] = None,
                 trg_prompt: Optional[str] = None) -> None:
        if not Path(src_line).is_file():
            raise FileNotFoundError(
                f"{src_line} not found. Please provide the absolute path to the file!")
        if trg_line is not None or trg_prompt is not None:
            trg_line, trg_prompt = self._split_at_sep(
                trg_line, trg_prompt, "trg",
                getattr(self.tokenizer["trg"], "sep_token", None))
        self.cache.append((src_line, trg_line, None, trg_prompt))
        self.reset_indices()

    def _src_example(self, idx: int):
        # never train mode: a stream is inference input
        wav_path, _ = self.lookup_item(idx=idx, lang="src")
        return self.tokenizer["src"](wav_path, is_train=False)


class BaseHuggingfaceDataset(BaseDataset):
    """A Huggingface ``datasets.Dataset`` whose ``COLUMN_NAME`` column maps
    each language to its text, with optional ``<lang>_prompt`` columns
    (joeynmt/datasets.py:866-969)."""

    COLUMN_NAME = "sentence"

    def __init__(self, path, src_lang, trg_lang, has_trg=True, has_prompt=None,
                 tokenizer=None, sequence_encoder=None, random_subset=-1,
                 task="MT", **kwargs):
        super().__init__(path=path, src_lang=src_lang, trg_lang=trg_lang,
                         split=kwargs["split"], has_trg=has_trg, has_prompt=has_prompt,
                         tokenizer=tokenizer, sequence_encoder=sequence_encoder,
                         random_subset=random_subset, task=task)
        self.dataset = self.load_data(path, **kwargs)
        self.reset_indices()

    def load_data(self, path: str, **kwargs) -> Any:
        # pylint: disable=import-outside-toplevel
        from datasets import Dataset, DatasetDict, config, load_dataset, load_from_disk

        on_disk = any(Path(path, marker).exists()
                      for marker in (config.DATASET_STATE_JSON_FILENAME,
                                     config.DATASETDICT_JSON_FILENAME))
        if on_disk:
            hf_dataset = load_from_disk(path)
            if isinstance(hf_dataset, DatasetDict):
                if kwargs["split"] not in hf_dataset:
                    raise ValueError(f"{path} has no split {kwargs['split']!r}")
                hf_dataset = hf_dataset[kwargs["split"]]
        else:
            hf_dataset = load_dataset(path, **kwargs)
        if not isinstance(hf_dataset, Dataset) or self.COLUMN_NAME not in hf_dataset.features:
            raise ValueError(f"{path}: expected a dataset with a {self.COLUMN_NAME!r} column")
        return hf_dataset

    def lookup_item(self, idx: int, lang: str) -> Tuple[str, Optional[str]]:
        line = self.dataset[idx]
        if lang not in line[self.COLUMN_NAME]:
            raise KeyError(f"row {idx} has no {lang!r} text")
        return line[self.COLUMN_NAME][lang], line.get(f"{lang}_prompt", None)

    def get_list(self, lang, tokenized=False, subsampled=True):
        indices = self.indices if subsampled else range(len(self))
        lines = [self.dataset[int(i)][self.COLUMN_NAME][lang] for i in indices]
        if tokenized:
            return [self.tokenizer[lang](line) for line in lines]
        return lines

    def __len__(self) -> int:
        return self.dataset.num_rows


class HuggingfaceTranslationDataset(BaseHuggingfaceDataset):
    """A dataset of ``datasets.features.Translation`` rows
    (joeynmt/datasets.py:972-1027): rows with an empty or missing side are
    dropped, and every text and prompt is pre-processed once at load."""

    COLUMN_NAME = "translation"

    def load_data(self, path: str, **kwargs) -> Any:
        dataset = super().load_data(path=path, **kwargs)
        from datasets.features import Translation  # pylint: disable=import-outside-toplevel

        feature = dataset.features[self.COLUMN_NAME]
        if not isinstance(feature, Translation):
            raise ValueError(f"Please cast `{self.COLUMN_NAME}` column to "
                             "datasets.features.Translation class.")
        sides = [self.src_lang] + ([self.trg_lang] if self.has_trg else [])
        missing = [lang for lang in sides if lang not in feature.languages]
        if missing:
            raise ValueError(f"{path}: no {missing} in {feature.languages}")

        def _pre_process(item):
            for lang in sides:
                item[self.COLUMN_NAME][lang] = self.tokenizer[lang].pre_process(
                    item[self.COLUMN_NAME][lang])
            for lang in (self.src_lang, self.trg_lang):
                if self.has_prompt[lang]:
                    item[f"{lang}_prompt"] = self.tokenizer[lang].pre_process(
                        item[f"{lang}_prompt"], allow_empty=True)
            return item

        def _drop_nan(item):
            return all(item[self.COLUMN_NAME][lang] is not None
                       and len(item[self.COLUMN_NAME][lang]) > 0 for lang in sides)

        dataset = dataset.filter(_drop_nan, desc="Dropping NaN...")
        return dataset.map(_pre_process, desc="Preprocessing...")


def build_dataset(dataset_type: str, path: Optional[str], src_lang: str, trg_lang: str,
                  split: str, tokenizer: Optional[Dict] = None,
                  sequence_encoder: Optional[Dict] = None,
                  has_prompt: Optional[Dict] = None, random_subset: int = -1,
                  task: str = "MT", **kwargs):
    """Dataset factory (joeynmt/datasets.py:1030-1161)."""
    placeholder = {src_lang: None, trg_lang: None}
    common = dict(src_lang=src_lang, trg_lang=trg_lang, split=split,
                  has_prompt=placeholder if has_prompt is None else has_prompt,
                  tokenizer=placeholder if tokenizer is None else tokenizer,
                  sequence_encoder=(placeholder if sequence_encoder is None
                                    else sequence_encoder), task=task)
    speech = dict(common, src_lang="src", trg_lang="trg")
    if dataset_type == "huggingface":
        # the dataset's own split name: dataset_cfg's ``split`` (``hf_split``
        # here), else the positional one, dev read as "validation"
        kwargs["split"] = kwargs.pop("hf_split", kwargs.get(
            "split", "validation" if split == "dev" else split))
        del common["split"]
        return HuggingfaceTranslationDataset(path=path, has_trg=True,
                                             random_subset=random_subset, **common,
                                             **kwargs)
    if dataset_type == "plain":
        base = Path(path)
        return PlaintextDataset(
            path=path, has_trg=base.with_suffix(f"{base.suffix}.{trg_lang}").is_file(),
            random_subset=random_subset, **common, **kwargs)
    if dataset_type == "tsv":
        return TsvDataset(path=path, has_trg=True, random_subset=random_subset,
                          **common, **kwargs)
    if dataset_type == "speech":
        if task != "S2T":
            raise ConfigurationError("speech datasets need task S2T")
        return SpeechDataset(path=path, has_trg=True, random_subset=random_subset,
                             **speech, **kwargs)
    if dataset_type in ("stream", "speech_stream"):
        if split != "test":
            raise ConfigurationError(f"{dataset_type} datasets are test data")
        if dataset_type == "stream":
            if task != "MT":
                raise ConfigurationError("stream datasets need task MT")
            return StreamDataset(path=path, has_trg=False, random_subset=-1,
                                 **common, **kwargs)
        if task != "S2T":
            raise ConfigurationError("speech_stream datasets need task S2T")
        return SpeechStreamDataset(path=None, has_trg=False, random_subset=-1,
                                   **speech, **kwargs)
    raise ConfigurationError(f"{dataset_type}: Unknown dataset type.")
