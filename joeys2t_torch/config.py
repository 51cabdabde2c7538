# coding: utf-8
"""
Configuration: special symbols, the `training` and `testing` sections, the
whole config, and the YAML config loader.

Counterpart of joeys2t_tpu/config.py (``SpecialSymbols`` :28,
``TrainConfig`` :45, ``TestConfig`` :113, ``BaseConfig`` :141,
``parse_special_symbols`` :181, ``log_config`` :201, ``load_config`` :210,
``parse_global_args`` :220, ``parse_train_args`` :259, ``parse_test_args``
:360, ``set_validation_args`` :435). ``use_cuda`` (default True) selects the
``cuda`` device and raises without one; ``use_cuda: False`` runs on the CPU.
``fp16`` selects bfloat16 compute on float32 masters. ``model_parallel``,
``pipeline_parallel`` and ``pipeline_microbatches`` are read as JAX reads
them (:284-292; both parallelisms at once raise by name); the model
section's ``sequence_parallel`` is read by the trainer. Every optimizer
of the JAX package is read, and sgd's ``momentum`` with it (JAX's
``build_optimizer`` reads it, but its trainer's ``TrainConfig`` has no
such field, so a JAX run drops it; the port applies it). ``profile_dir``
names the directory of the trainer's profiler window.
:func:`check_ported` refuses, before a run loads any data, the sacrebleu
tokenizers the port does not have: ``ja-mecab`` and ``ko-mecab`` (they
need MeCab) and ``spm``, ``flores101`` and ``flores200`` (they need a
downloaded SentencePiece model).
As in JAX, the ``JOEYS2T_BEAM_REORDER`` environment variable overrides
``beam_reorder`` when the `testing` section is parsed, never in the
decode loop.

The port depends on torch, numpy and the standard library only, so it reads
the repository's configs with its own YAML reader: block mappings by
indentation, ``- item`` block lists, ``[a, b]`` flow lists and ``{a: 1}``
flow mappings (nested, and continued over several lines), quoted and plain
scalars resolved as PyYAML's safe loader resolves them (YAML 1.1 booleans,
ints, floats, null), and ``#`` comments. Anchors and multi-line strings are
rejected with an error rather than misread. ``dump_yaml`` writes a config
back in that subset.
"""
import dataclasses
import json
import math
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from joeys2t_torch.helpers import resolve_device
from joeys2t_torch.utils.logging import get_logger

logger = get_logger(__name__)

OPTIMIZERS = ("adam", "adamw", "adafactor", "adagrad", "adadelta", "rmsprop", "sgd")
# sacrebleu tokenizers the port lacks, and what each needs
UNPORTED_TOKENIZERS = {"ja-mecab": "MeCab", "ko-mecab": "MeCab",
                       "spm": "a downloaded SentencePiece model",
                       "flores101": "a downloaded SentencePiece model",
                       "flores200": "a downloaded SentencePiece model"}
# sacrebleu's BLEU default tokenizer by target language (13a otherwise)
BLEU_DEFAULT_TOKENIZERS = {"zh": "zh", "ja": "ja-mecab", "ko": "ko-mecab"}


class ConfigurationError(Exception):
    """Custom exception for misspecifications of configuration."""


@dataclasses.dataclass(frozen=True)
class SpecialSymbols:
    """Special symbol ids/tokens (defaults: joeynmt/config.py:128-140)."""

    unk_id: int = 0
    unk_token: str = "<unk>"
    pad_id: int = 1
    pad_token: str = "<pad>"
    bos_id: int = 2
    bos_token: str = "<s>"
    eos_id: int = 3
    eos_token: str = "</s>"
    sep_id: Optional[int] = None
    sep_token: Optional[str] = None
    lang_tags: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """`training` section (joeynmt/config.py:26-65, defaults :252-353)."""

    load_model: Optional[Path] = None
    load_encoder: Optional[Path] = None
    load_decoder: Optional[Path] = None
    reset_best_ckpt: bool = False
    reset_scheduler: bool = False
    reset_optimizer: bool = False
    reset_iter_state: bool = False
    loss: str = "crossentropy"
    normalization: str = "batch"
    label_smoothing: float = 0.0
    optimizer: str = "adam"
    adam_betas: List[float] = dataclasses.field(default_factory=lambda: [0.9, 0.999])
    # host->device dtype of float speech features; "auto" uploads bfloat16
    # when the encoder computes in bfloat16 (it casts its input anyway)
    feature_dtype: str = "auto"
    learning_rate: float = 0.005
    learning_rate_min: float = 0.0001
    learning_rate_factor: float = 1
    learning_rate_warmup: int = 4000
    scheduling: Optional[str] = None
    patience: int = 5
    decrease_factor: float = 0.5
    weight_decay: float = 0.0
    momentum: float = 0.0  # sgd's (optax.trace)
    clip_grad_norm: Optional[float] = None
    clip_grad_val: Optional[float] = None
    keep_best_ckpts: int = 5
    logging_freq: int = 100
    validation_freq: int = 1000
    print_valid_sents: List[int] = dataclasses.field(default_factory=lambda: [0, 1, 2])
    early_stopping_metric: str = "ppl"
    minimize_metric: bool = True
    shuffle: bool = True
    epochs: int = 3
    max_updates: float = float("inf")
    batch_size: int = 1
    batch_type: str = "sentence"
    batch_multiplier: int = 1
    ctc_weight: float = 0.0
    # the dtype Adam keeps its first moment in (optax's mu_dtype); None: float32
    moment_dtype: Optional[str] = None
    # tensor / pipeline parallelism (JAX's (data, model) and (data, pipe) meshes)
    model_parallel: int = 1
    pipeline_parallel: int = 1
    pipeline_microbatches: int = 0  # 0: 2 * pipeline_parallel
    # a torch.profiler window over the updates JOEYS2T_PROFILE_WINDOW names
    # ("10,20" by default), written here; JOEYS2T_PROFILE_DIR overrides it
    profile_dir: Optional[Path] = None


@dataclasses.dataclass(frozen=True)
class TestConfig:
    """`testing` section (joeynmt/config.py:67-86, defaults :356-446)."""

    __test__ = False  # the Test* name is domain jargon, not a pytest class

    load_model: Optional[Path] = None
    batch_size: int = 64
    batch_type: str = "sentence"
    max_output_length: int = -1
    min_output_length: int = 1
    eval_metrics: List[str] = dataclasses.field(default_factory=list)
    sacrebleu_cfg: Dict = dataclasses.field(default_factory=dict)
    beam_size: int = 1
    beam_alpha: float = -1
    n_best: int = 1
    return_attention: bool = False
    return_prob: str = "none"
    generate_unk: bool = True
    repetition_penalty: float = -1
    no_repeat_ngram_size: int = -1
    beam_reorder: str = "auto"


@dataclasses.dataclass(frozen=True)
class BaseConfig:
    """Top-level parsed config (joeynmt/config.py:88-106)."""

    name: str
    model_dir: Path
    device: torch.device
    task: str = "MT"
    joeynmt_version: Optional[str] = "2.3.0"
    num_workers: int = 0
    fp16: bool = False  # bfloat16 compute on float32 masters
    seed: int = 42
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    test: TestConfig = dataclasses.field(default_factory=TestConfig)
    data: Dict = dataclasses.field(default_factory=dict)
    model: Dict = dataclasses.field(default_factory=dict)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.fp16 else torch.float32


def _check_path(path, allow_empty: bool = True) -> Optional[Path]:
    """An absolute path; one that must exist raises when it does not."""
    if path is not None:
        path = Path(path).absolute()
        if not allow_empty and not path.exists():
            raise FileNotFoundError(f"{path} not found.")
    return path


def _check_options(name: str, choice: Any, valid_options: List[Any]) -> None:
    """joeynmt/config.py:118-125"""
    if choice not in valid_options:
        valids = "{" + ", ".join([f"`{option}`" for option in valid_options]) + "}"
        raise ConfigurationError(f"Invalid setting for `{name}`. Valid choices: {valids}.")


def parse_special_symbols(cfg) -> SpecialSymbols:
    """Apply special-symbol defaults (joeynmt/config.py:128-140)."""
    if isinstance(cfg, SpecialSymbols):
        return cfg
    cfg = dict(cfg or {})
    return SpecialSymbols(
        unk_id=cfg.get("unk_id", 0), unk_token=cfg.get("unk_token", "<unk>"),
        pad_id=cfg.get("pad_id", 1), pad_token=cfg.get("pad_token", "<pad>"),
        bos_id=cfg.get("bos_id", 2), bos_token=cfg.get("bos_token", "<s>"),
        eos_id=cfg.get("eos_id", 3), eos_token=cfg.get("eos_token", "</s>"),
        sep_id=cfg.get("sep_id", None), sep_token=cfg.get("sep_token", None),
        lang_tags=cfg.get("lang_tags", []))


def log_config(cfg: Dict, prefix: str = "cfg") -> None:
    """Echo the config to the log (joeynmt/config.py:143-156)."""
    for k, v in cfg.items():
        if isinstance(v, dict):
            log_config(v, prefix=".".join([prefix, k]))
        else:
            logger.info("%34s : %s", ".".join([prefix, k]), v)


def parse_global_args(cfg: Dict, rank: int = 0, mode: str = "train") -> BaseConfig:
    """Parse and validate the whole config (joeynmt/config.py:176-249). The
    device is ``cuda`` unless ``use_cuda`` is False; without a card the
    default raises."""
    del rank  # every rank parses the same config
    task = cfg.get("task", cfg["data"].get("task", "MT")).upper()
    _check_options("task", task, ["MT", "S2T"])
    use_cuda = bool(cfg.get("use_cuda", cfg["training"].get("use_cuda", True)))
    if use_cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; set `use_cuda: False` in the "
                           "config to run on the CPU")
    device = resolve_device("cuda" if use_cuda else "cpu")
    cfg["data"]["special_symbols"] = parse_special_symbols(
        cfg["data"].get("special_symbols", {}))
    return BaseConfig(
        name=cfg["name"],
        joeynmt_version=cfg.get("joeynmt_version", "2.3.0"),
        task=task,
        model_dir=_check_path(cfg["model_dir"]),
        device=device,
        num_workers=cfg.get("num_workers", cfg["training"].get("num_workers", 0)),
        fp16=cfg.get("fp16", cfg["training"].get("fp16", False)),
        seed=cfg.get("random_seed", 42),
        train=parse_train_args(cfg["training"], mode),
        test=parse_test_args(cfg["testing"], mode),
        data=cfg["data"],
        model=cfg["model"],
    )


def parse_train_args(cfg: Dict, mode: str = "train") -> TrainConfig:
    """Parse and validate the `training` section (joeynmt/config.py:252-353)."""
    normalization = cfg.get("normalization", "batch").lower()
    _check_options("normalization", normalization, ["batch", "tokens", "none"])
    loss_type = cfg.get("loss", "crossentropy")
    _check_options("loss", loss_type, ["crossentropy", "crossentropy-ctc"])
    optimizer = cfg.get("optimizer", "adam").lower()
    _check_options("optimizer", optimizer, list(OPTIMIZERS))
    keep_best_ckpts = int(cfg.get("keep_best_ckpts", 5))
    if cfg.get("keep_last_ckpts") is not None:  # backward compatibility
        keep_best_ckpts = int(cfg["keep_last_ckpts"])
        logger.warning("`keep_last_ckpts` option is outdated. Please use "
                       "`keep_best_ckpts`, instead.")
    early_stopping_metric = cfg.get("early_stopping_metric", "ppl").lower()
    _check_options("early_stopping_metric", early_stopping_metric,
                   ["acc", "loss", "ppl", "bleu", "chrf", "wer"])
    batch_type = cfg.get("batch_type", "sentence").lower()
    _check_options("batch_type", batch_type, ["sentence", "token"])
    feature_dtype = str(cfg.get("feature_dtype", "auto")).lower()
    _check_options("feature_dtype", feature_dtype, ["auto", "float32", "bfloat16"])
    if cfg.get("clip_grad_val") is not None and cfg.get("clip_grad_norm") is not None:
        raise ConfigurationError(
            "You can only specify either clip_grad_val or clip_grad_norm.")
    logging_freq = cfg.get("logging_freq", 100)
    validation_freq = cfg.get("validation_freq", 1000)
    if logging_freq > validation_freq:
        raise ConfigurationError("`logging_freq` must be smaller than `validation_freq`.")
    if validation_freq % logging_freq != 0:
        raise ConfigurationError("`validation_freq` must be divisible by `logging_freq`.")

    moment_dtype = cfg.get("moment_dtype", None)
    if moment_dtype is not None:
        moment_dtype = str(moment_dtype).lower()
    _check_options("moment_dtype", moment_dtype, [None, "bfloat16", "float32"])

    model_parallel = int(cfg.get("model_parallel", 1))
    if model_parallel < 1:
        raise ConfigurationError("`model_parallel` must be >= 1.")
    pipeline_parallel = int(cfg.get("pipeline_parallel", 1))
    if pipeline_parallel < 1:
        raise ConfigurationError("`pipeline_parallel` must be >= 1.")
    if pipeline_parallel > 1 and model_parallel > 1:
        raise ConfigurationError(
            "`pipeline_parallel` and `model_parallel` are mutually exclusive.")
    pipeline_microbatches = int(cfg.get("pipeline_microbatches", 0))
    if pipeline_microbatches < 0:
        raise ConfigurationError("`pipeline_microbatches` must be >= 0.")

    is_test = mode != "train"
    return TrainConfig(
        load_model=_check_path(cfg.get("load_model", None), allow_empty=is_test),
        load_encoder=_check_path(cfg.get("load_encoder", None), allow_empty=is_test),
        load_decoder=_check_path(cfg.get("load_decoder", None), allow_empty=is_test),
        reset_best_ckpt=cfg.get("reset_best_ckpt", False),
        reset_scheduler=cfg.get("reset_scheduler", False),
        reset_optimizer=cfg.get("reset_optimizer", False),
        reset_iter_state=cfg.get("reset_iter_state", False),
        normalization=normalization,
        loss=loss_type,
        label_smoothing=cfg.get("label_smoothing", 0.0),
        optimizer=optimizer,
        adam_betas=cfg.get("adam_betas", [0.9, 0.999]),
        feature_dtype=feature_dtype,
        learning_rate=cfg.get("learning_rate", 0.005),
        learning_rate_min=cfg.get("learning_rate_min", 0.0001),
        learning_rate_factor=cfg.get("learning_rate_factor", 1),
        learning_rate_warmup=cfg.get("learning_rate_warmup", 4000),
        scheduling=cfg.get("scheduling", None),  # None == constant
        patience=cfg.get("patience", 5),
        decrease_factor=cfg.get("decrease_factor", 0.5),
        weight_decay=cfg.get("weight_decay", 0.0),
        momentum=cfg.get("momentum", 0.0),
        clip_grad_norm=cfg.get("clip_grad_norm", None),
        clip_grad_val=cfg.get("clip_grad_val", None),
        keep_best_ckpts=keep_best_ckpts,
        logging_freq=logging_freq,
        validation_freq=validation_freq,
        print_valid_sents=cfg.get("print_valid_sents", [0, 1, 2]),
        early_stopping_metric=early_stopping_metric,
        minimize_metric=early_stopping_metric in ["ppl", "loss", "wer"],
        shuffle=cfg.get("shuffle", True),
        epochs=cfg.get("epochs", 3),
        max_updates=cfg.get("updates", float("inf")),
        batch_size=cfg["batch_size"],
        batch_type=batch_type,
        batch_multiplier=cfg.get("batch_multiplier", 1),
        moment_dtype=moment_dtype,
        ctc_weight=cfg.get("ctc_weight", 0.0),
        model_parallel=model_parallel,
        pipeline_parallel=pipeline_parallel,
        pipeline_microbatches=pipeline_microbatches,
        profile_dir=_check_path(cfg.get("profile_dir", None)),
    )


def parse_test_args(cfg: Dict, mode: str = "test") -> TestConfig:
    """Parse and validate the `testing` section (joeynmt/config.py:356-446).
    ``beam_reorder`` (``auto``, ``lazy`` or ``physical``) is taken from the
    ``JOEYS2T_BEAM_REORDER`` environment variable where it is set, as JAX
    does (joeys2t_tpu/config.py:409-412)."""
    batch_size = cfg.get("batch_size", 64)
    batch_type = cfg.get("batch_type", "sentence").lower()
    _check_options("batch_type", batch_type, ["sentence", "token"])
    if batch_size > 1000 and batch_type == "sentence":
        logger.warning("WARNING: Are you sure you meant to work on huge batches like "
                       "this? `batch_size` is > 1000 for sentence-batching. Consider "
                       "decreasing it or switching to `batch_type: 'token'`.")
    if "eval_metrics" in cfg:
        eval_metrics = [s.strip().lower() for s in cfg["eval_metrics"]]
    elif "eval_metric" in cfg:
        eval_metrics = [cfg["eval_metric"].strip().lower()]
        logger.warning("`eval_metric` option is obsolete. Please use `eval_metrics`, "
                       "instead.")
    else:
        eval_metrics = []
    for eval_metric in eval_metrics:
        _check_options("eval_metric", eval_metric,
                       ["bleu", "chrf", "token_accuracy", "sequence_accuracy", "wer"])
    sacrebleu_cfg: Dict = cfg.get("sacrebleu_cfg", {})
    if "sacrebleu" in cfg:
        sacrebleu_cfg = cfg["sacrebleu"]
        logger.warning("`sacrebleu` option is obsolete. Please use `sacrebleu_cfg`, "
                       "instead.")
    n_best = cfg.get("n_best", 1)
    if n_best < 1:
        raise ConfigurationError("N-best size must be > 0.")
    beam_size = cfg.get("beam_size", 1)
    if beam_size < 1:
        raise ConfigurationError("Beam size must be > 0.")
    if n_best > beam_size:
        raise ConfigurationError("`n_best` must be smaller than or equal to `beam_size`.")
    beam_alpha = cfg.get("beam_alpha", -1)
    if "alpha" in cfg:
        beam_alpha = cfg["alpha"]
        logger.warning("`alpha` option is obsolete. Please use `beam_alpha`, instead.")
    return_prob = cfg.get("return_prob", "none")
    _check_options("return_prob", return_prob, ["hyp", "ref", "none"])
    repetition_penalty: float = cfg.get("repetition_penalty", -1)
    if 0 < repetition_penalty < 1:
        raise ConfigurationError(
            "Repetition penalty must be > 1. (-1 indicates no repetition penalty.)")
    beam_reorder = str(os.environ.get("JOEYS2T_BEAM_REORDER",
                                      cfg.get("beam_reorder", "auto"))).lower()
    _check_options("beam_reorder", beam_reorder, ["auto", "lazy", "physical"])
    return TestConfig(
        load_model=_check_path(cfg.get("load_model", None), allow_empty=mode == "train"),
        batch_size=batch_size,
        batch_type=batch_type,
        max_output_length=cfg.get("max_output_length", -1),
        min_output_length=cfg.get("min_output_length", 1),
        eval_metrics=eval_metrics,
        sacrebleu_cfg=sacrebleu_cfg,
        beam_size=beam_size,
        beam_alpha=beam_alpha,
        n_best=n_best,
        return_attention=cfg.get("return_attention", False),
        return_prob=return_prob,
        generate_unk=cfg.get("generate_unk", True),
        repetition_penalty=repetition_penalty,
        no_repeat_ngram_size=cfg.get("no_repeat_ngram_size", -1),
        beam_reorder=beam_reorder,
    )


def check_ported(args: BaseConfig) -> None:
    """Raise ``NotImplementedError`` for a sacrebleu tokenizer of the
    `testing` section that the port does not have (``UNPORTED_TOKENIZERS``),
    named in ``sacrebleu_cfg``'s ``tokenize`` or, for BLEU, chosen by its
    ``trg_lang``, so that ``train``, ``test`` and ``translate`` refuse it
    before loading any data rather than where it would first run (at the
    first validation)."""
    sacrebleu_cfg = args.test.sacrebleu_cfg or {}
    names = {sacrebleu_cfg.get("tokenize")}
    if "bleu" in args.test.eval_metrics and sacrebleu_cfg.get("tokenize") is None:
        names.add(BLEU_DEFAULT_TOKENIZERS.get(sacrebleu_cfg.get("trg_lang", "")))
    for name in sorted(n for n in names if n in UNPORTED_TOKENIZERS):
        raise NotImplementedError(f"the sacrebleu tokenizer {name!r} (`sacrebleu_cfg`) is "
                                  f"not ported: it needs {UNPORTED_TOKENIZERS[name]}")


def set_validation_args(args: TestConfig) -> TestConfig:
    """Greedy-only overrides for in-training validation
    (joeynmt/config.py:449-472)."""
    return dataclasses.replace(args, beam_size=1, n_best=1, return_prob="none",
                               generate_unk=True, repetition_penalty=-1,
                               no_repeat_ngram_size=-1)


def load_config(cfg_file: str = "configs/default.yaml") -> Dict:
    """Load a raw YAML config (joeynmt/config.py:159-173)."""
    path = Path(cfg_file).absolute()
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found.")
    cfg = parse_yaml(path.read_text(encoding="utf-8"))
    if "model_dir" not in cfg:
        cfg["model_dir"] = cfg["training"]["model_dir"]
    return cfg


def _yaml_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        if math.isnan(value):
            return ".nan"
        text = repr(value)
        # YAML 1.1 reads a float only with a dot: 1e-06 -> 1.0e-06
        return text.replace("e", ".0e", 1) if "e" in text and "." not in text else text
    return json.dumps(str(value))  # a JSON string is a double-quoted YAML scalar


def dump_yaml(cfg: Dict, indent: int = 0) -> str:
    """A config (nested dicts, lists of scalars, scalars) as YAML that
    ``parse_yaml`` and PyYAML's safe loader both read back unchanged."""
    lines = []
    for key, value in cfg.items():
        pad = " " * indent
        if isinstance(value, dict):
            lines.append(f"{pad}{key}:")
            lines.append(dump_yaml(value, indent + 4).rstrip("\n"))
        elif isinstance(value, (list, tuple)):
            lines.append(f"{pad}{key}: [{', '.join(_yaml_scalar(v) for v in value)}]")
        else:
            lines.append(f"{pad}{key}: {_yaml_scalar(value)}")
    return "\n".join(line for line in lines if line) + "\n"


# ------------------------------------------------------------- YAML subset
_BOOL = {"true": True, "yes": True, "on": True,
         "false": False, "no": False, "off": False}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_SPECIAL_FLOAT = {".inf": float("inf"), "-.inf": float("-inf"),
                  "+.inf": float("inf"), ".nan": float("nan")}


def _scalar(text: str) -> Any:
    """A plain or quoted scalar, resolved as yaml.safe_load resolves it."""
    if text[:1] in "'\"":
        quote = text[0]
        if len(text) < 2 or text[-1] != quote:
            raise ConfigurationError(f"unterminated string: {text}")
        body = text[1:-1]
        return body.replace("''", "'") if quote == "'" else bytes(
            body, "utf-8").decode("unicode_escape")
    if text[:1] in "&*!|>{":
        raise ConfigurationError(f"unsupported YAML construct: {text}")
    if text in _NULL:
        return None
    if text.lower() in _BOOL and text in (text.lower(), text.capitalize(),
                                          text.upper()):
        return _BOOL[text.lower()]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) and text not in (".", "-.", "+."):
        return float(text.replace("_", ""))
    if text.lower() in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[text.lower()]
    return text


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that is not inside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _flow_depth(text: str) -> int:
    """Open ``[``/``{`` minus closed ``]``/``}`` outside quotes."""
    depth, quote = 0, None
    for ch in text:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth


def _split_flow(body: str) -> List[str]:
    items, depth, quote, cur = [], 0, None, ""
    for ch in body:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(cur.strip())
            cur = ""
            continue
        cur += ch
    if cur.strip():
        items.append(cur.strip())
    return items


def _value(text: str) -> Any:
    if text.startswith("["):
        if not text.endswith("]"):
            raise ConfigurationError(f"unterminated flow list: {text}")
        return [_value(item) for item in _split_flow(text[1:-1])]
    if text.startswith("{"):
        if not text.endswith("}"):
            raise ConfigurationError(f"unterminated flow mapping: {text}")
        out = {}
        for item in _split_flow(text[1:-1]):
            kv = _split_key(item)
            if kv is None:
                raise ConfigurationError(f"not a key: value pair in a flow mapping: {item}")
            key = kv[0][1:-1] if kv[0][:1] in ("'", '"') else _scalar(kv[0])
            out[key] = _value(kv[1]) if kv[1] else None
        return out
    return _scalar(text)


def _split_key(text: str) -> Optional[Tuple[str, str]]:
    """``key: value`` -> (key, value text), or None when not a mapping line.
    A quoted key keeps its quotes, so that the caller can tell it from a
    plain one."""
    m = re.match(r"""^("[^"]*"|'[^']*'|[^'"\[\]{}#:][^:#]*?)\s*:(\s+(.*))?$""", text)
    if m is None:
        return None
    return m.group(1), (m.group(3) or "")


def parse_yaml(text: str) -> Any:
    """Parse the YAML subset described in the module docstring."""
    lines = []
    for raw in text.splitlines():
        if raw.lstrip().startswith(("---", "...")) and not raw.startswith(" "):
            continue
        line = _strip_comment(raw.replace("\t", "    "))
        if not line.strip():
            continue
        if lines and _flow_depth(lines[-1][1]) > 0:  # a flow collection goes on
            lines[-1] = (lines[-1][0], f"{lines[-1][1]} {line.strip()}")
        else:
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    value, pos = _block(lines, 0, lines[0][0] if lines else 0)
    if pos != len(lines):
        raise ConfigurationError(f"cannot parse YAML line: {lines[pos][1]}")
    return value if lines else None


def _block(lines, pos: int, indent: int):
    """Parse the block starting at ``lines[pos]`` whose lines sit at ``indent``."""
    if lines[pos][1].startswith("- ") or lines[pos][1] == "-":
        out_list = []
        while pos < len(lines) and lines[pos][0] == indent and (
                lines[pos][1].startswith("- ") or lines[pos][1] == "-"):
            rest = lines[pos][1][1:].strip()
            pos += 1
            if rest:
                if _split_key(rest) is not None:
                    raise ConfigurationError(f"unsupported YAML construct: {rest}")
                out_list.append(_value(rest))
            elif pos < len(lines) and lines[pos][0] > indent:
                item, pos = _block(lines, pos, lines[pos][0])
                out_list.append(item)
            else:
                out_list.append(None)
        return out_list, pos
    out: Dict = {}
    while pos < len(lines) and lines[pos][0] == indent:
        kv = _split_key(lines[pos][1])
        if kv is None:
            raise ConfigurationError(f"cannot parse YAML line: {lines[pos][1]}")
        key, rest = kv
        key = key[1:-1] if key[:1] in ("'", '"') else key
        pos += 1
        if rest:
            out[key] = _value(rest)
        elif pos < len(lines) and (lines[pos][0] > indent or (
                lines[pos][0] == indent and lines[pos][1].startswith("- "))):
            out[key], pos = _block(lines, pos, lines[pos][0])
        else:
            out[key] = None
    return out, pos
