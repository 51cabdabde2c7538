# coding: utf-8
"""
Configuration: special symbols, the `training` section and the YAML config
loader.

Counterpart of joeys2t_tpu/config.py (``SpecialSymbols`` :28,
``ConfigurationError`` :23, ``TrainConfig`` :45, ``load_config`` :210,
``parse_train_args`` :259). ``TrainConfig`` keeps the fields the train step
reads; the `training` options of the parts the port does not have yet
(checkpoint loading, profiling, model and pipeline parallelism, optimizers
other than adam/adamw, bf16 moments) raise ``NotImplementedError`` when set. The port depends on
torch, numpy and the standard library only, so it reads the repository's
configs with its own YAML reader: block mappings by indentation, ``- item``
block lists, ``[a, b]`` flow lists, quoted and plain scalars resolved as
PyYAML's safe loader resolves them (YAML 1.1 booleans, ints, floats, null),
and ``#`` comments. Anchors, multi-line strings and flow mappings are
rejected with an error rather than misread.
"""
import dataclasses
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

PORTED_OPTIMIZERS = ("adam", "adamw")


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
    """The fields of the JAX package's ``TrainConfig`` (joeynmt/config.py:26-65,
    defaults :252-353) that the train step reads."""

    loss: str = "crossentropy"
    normalization: str = "batch"
    label_smoothing: float = 0.0
    optimizer: str = "adam"
    adam_betas: List[float] = dataclasses.field(default_factory=lambda: [0.9, 0.999])
    feature_dtype: str = "auto"
    learning_rate: float = 0.005
    learning_rate_min: float = 0.0001
    learning_rate_factor: float = 1
    learning_rate_warmup: int = 4000
    scheduling: Optional[str] = None
    patience: int = 5
    decrease_factor: float = 0.5
    weight_decay: float = 0.0
    clip_grad_norm: Optional[float] = None
    clip_grad_val: Optional[float] = None
    minimize_metric: bool = True
    max_updates: float = float("inf")
    batch_size: int = 1
    batch_type: str = "sentence"
    batch_multiplier: int = 1
    ctc_weight: float = 0.0


def _check_options(name: str, choice: Any, valid_options: List[Any]) -> None:
    """joeynmt/config.py:118-125"""
    if choice not in valid_options:
        valids = "{" + ", ".join([f"`{option}`" for option in valid_options]) + "}"
        raise ConfigurationError(f"Invalid setting for `{name}`. Valid choices: {valids}.")


def parse_train_args(cfg: Dict) -> TrainConfig:
    """Parse and validate the `training` section (joeys2t_tpu/config.py:259)
    for the train step; options of parts not ported yet raise
    ``NotImplementedError``."""
    normalization = cfg.get("normalization", "batch").lower()
    _check_options("normalization", normalization, ["batch", "tokens", "none"])
    loss_type = cfg.get("loss", "crossentropy")
    _check_options("loss", loss_type, ["crossentropy", "crossentropy-ctc"])
    optimizer = cfg.get("optimizer", "adam").lower()
    _check_options("optimizer", optimizer, ["adam", "adamw", "adafactor", "adagrad",
                                            "adadelta", "rmsprop", "sgd"])
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

    unported = {
        "load_model": cfg.get("load_model") is not None,
        "load_encoder": cfg.get("load_encoder") is not None,
        "load_decoder": cfg.get("load_decoder") is not None,
        "profile_dir": cfg.get("profile_dir") is not None,
        "moment_dtype": cfg.get("moment_dtype") is not None,
        "model_parallel": int(cfg.get("model_parallel", 1)) != 1,
        "pipeline_parallel": int(cfg.get("pipeline_parallel", 1)) != 1,
        f"optimizer {optimizer}": optimizer not in PORTED_OPTIMIZERS,
    }
    for option, is_set in unported.items():
        if is_set:
            raise NotImplementedError(f"training option `{option}` is not ported yet")

    return TrainConfig(
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
        clip_grad_norm=cfg.get("clip_grad_norm", None),
        clip_grad_val=cfg.get("clip_grad_val", None),
        minimize_metric=early_stopping_metric in ["ppl", "loss", "wer"],
        max_updates=cfg.get("updates", float("inf")),
        batch_size=cfg["batch_size"],
        batch_type=batch_type,
        batch_multiplier=cfg.get("batch_multiplier", 1),
        ctc_weight=cfg.get("ctc_weight", 0.0),
    )


def load_config(cfg_file: str = "configs/default.yaml") -> Dict:
    """Load a raw YAML config (joeynmt/config.py:159-173)."""
    path = Path(cfg_file).absolute()
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found.")
    cfg = parse_yaml(path.read_text(encoding="utf-8"))
    if "model_dir" not in cfg:
        cfg["model_dir"] = cfg["training"]["model_dir"]
    return cfg


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


def _split_flow(body: str) -> List[str]:
    items, depth, quote, cur = [], 0, None, ""
    for ch in body:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
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
    return _scalar(text)


def _split_key(text: str) -> Optional[Tuple[str, str]]:
    """``key: value`` -> (key, value text), or None when not a mapping line."""
    m = re.match(r"""^("[^"]*"|'[^']*'|[^'"\[\]{}#:][^:#]*?)\s*:(\s+(.*))?$""", text)
    if m is None:
        return None
    key = m.group(1)
    if key[:1] in "'\"":
        key = key[1:-1]
    return key, (m.group(3) or "")


def parse_yaml(text: str) -> Any:
    """Parse the YAML subset described in the module docstring."""
    lines = []
    for raw in text.splitlines():
        if raw.lstrip().startswith(("---", "...")) and not raw.startswith(" "):
            continue
        line = _strip_comment(raw.replace("\t", "    "))
        if line.strip():
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
        pos += 1
        if rest:
            out[key] = _value(rest)
        elif pos < len(lines) and (lines[pos][0] > indent or (
                lines[pos][0] == indent and lines[pos][1].startswith("- "))):
            out[key], pos = _block(lines, pos, lines[pos][0])
        else:
            out[key] = None
    return out, pos
