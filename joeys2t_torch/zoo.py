# coding: utf-8
"""
Pretrained model zoo (counterpart of joeys2t_tpu/zoo.py, itself of the
reference's hubconf.py:110-290).

    from joeys2t_torch.zoo import load
    hub = load("librispeech_100h_en_asr")          # fetched on first use
    hub = load("local", model_dir="path/to/dir")    # a snapshot on disk
    hub.generate(["audio.wav"])

A named entry resolves to a snapshot directory under
``~/.cache/joeys2t_torch/zoo/<name>``: fetched from its primary source (the
Heidelberg tarball, or for ``iwslt14_prompt`` the Huggingface repository)
with the other as the fallback, each into a staging directory that is
renamed into the cache only once it holds the entry's config and a
checkpoint, so a failed transfer never leaves a half snapshot behind
(:67-108). A reference (torch joeynmt) checkpoint converts in place once:
the port's parameter names are the reference's, so only the sinusoidal
``pe`` tables and BatchNorm's ``num_batches_tracked`` counters go, and the
optimizer, scheduler and iterator states (:157-184).
"""
import shutil
import tarfile
import urllib.request
from pathlib import Path
from typing import Optional

import torch

from joeys2t_torch.checkpoints import save_checkpoint
from joeys2t_torch.hub_interface import TranslatorHubInterface, load_model_dir
from joeys2t_torch.utils.logging import get_logger

logger = get_logger(__name__)

BASE_URL = "https://www.cl.uni-heidelberg.de/statnlpgroup/joeynmt2"
HF_ORG = "may-ohta"  # the reference's snapshot_download repository owner

# name -> (snapshot base name, checkpoint file, config file, primary source)
ENTRIES = {
    "iwslt14_prompt": ("iwslt14_prompt", "avg5.ckpt", "config.yaml", "hf"),
    "transformer_iwslt14_deen_bpe": ("transformer_iwslt14_deen_bpe", "best.ckpt",
                                     "config_v2.3.yaml", "remote"),
    "rnn_iwslt14_deen_bpe": ("rnn_iwslt14_deen_bpe", "best.ckpt", "config_v2.3.yaml",
                             "remote"),
    "wmt14_deen": ("wmt14_deen", "avg5.ckpt", "config.yaml", "remote"),
    "wmt14_ende": ("wmt14_ende", "avg5.ckpt", "config.yaml", "remote"),
    "jparacrawl_jaen": ("jparacrawl_jaen", "avg5.ckpt", "config.yaml", "remote"),
    "jparacrawl_enja": ("jparacrawl_enja", "avg5.ckpt", "config.yaml", "remote"),
    "librispeech_960h_en_asr": ("librispeech960h", "avg10.ckpt", "config.yaml", "remote"),
    "librispeech_100h_en_asr": ("librispeech100h", "avg10.ckpt", "config.yaml", "remote"),
    "mustc_v2_en_asr": ("mustc_asr", "avg10.ckpt", "config.yaml", "remote"),
    "mustc_v2_ende_mt": ("mustc_mt", "avg5.ckpt", "config.yaml", "remote"),
    "mustc_v2_ende_st": ("mustc_st", "avg10.ckpt", "config.yaml", "remote"),
}


def _cache_dir() -> Path:
    d = Path.home() / ".cache" / "joeys2t_torch" / "zoo"
    d.mkdir(parents=True, exist_ok=True)
    return d


def _snapshot_complete(snapshot: Path, cfg_name: str) -> bool:
    """The entry's config and at least one checkpoint are there (metadata
    or a partial file from a failed transfer is not a snapshot)."""
    return (snapshot.is_dir() and (snapshot / cfg_name).is_file()
            and any(snapshot.glob("*.ckpt")))


def _download_and_extract(name: str) -> Path:
    """The cached snapshot of entry ``name``, fetched when missing: the
    primary source first, the other as fallback, each staged and renamed
    into place only when complete."""
    base, _, cfg_name, primary = ENTRIES[name]
    target = _cache_dir() / name
    if _snapshot_complete(target, cfg_name):
        return target
    if target.exists():
        logger.warning("Discarding incomplete cached snapshot %s", target)
        shutil.rmtree(target, ignore_errors=True)
    errors = []
    for source in (("hf", "remote") if primary == "hf" else ("remote", "hf")):
        fetch = _fetch_remote_tarball if source == "remote" else _fetch_hf_snapshot
        staging = _cache_dir() / f"_staging_{name}"
        shutil.rmtree(staging, ignore_errors=True)
        try:
            fetch(base, staging)
            if not _snapshot_complete(staging, cfg_name):
                raise RuntimeError(f"snapshot is missing {cfg_name} or a *.ckpt file")
            staging.replace(target)
            return target
        except Exception as e:  # pylint: disable=broad-except - try the next source
            errors.append(f"{source}: {e}")
            logger.warning("zoo source %s failed for %s: %s", source, name, e)
        finally:
            shutil.rmtree(staging, ignore_errors=True)
    raise RuntimeError(f"Could not fetch '{name}' from any source ({'; '.join(errors)}). "
                       f"Offline, place the extracted snapshot at {target} by hand, or "
                       f"use load('local', model_dir=...).")


def _fetch_hf_snapshot(base: str, target: Path) -> None:
    """``huggingface_hub.snapshot_download`` of ``<HF_ORG>/<base>``."""
    from huggingface_hub import snapshot_download

    snapshot_download(repo_id=f"{HF_ORG}/{base}", local_dir=target)
    if not (target.is_dir() and any(target.iterdir())):
        raise RuntimeError(f"empty snapshot {target}")


def _fetch_remote_tarball(base: str, target: Path) -> None:
    """``<BASE_URL>/<base>.tar.gz``, extracted with the ``data`` filter
    (no absolute, escaping or link members); its one top-level directory
    becomes ``target``."""
    archive = f"{base}.tar.gz"
    url = f"{BASE_URL}/{archive}"
    tar_path = _cache_dir() / archive
    logger.info("Downloading %s ...", url)
    urllib.request.urlretrieve(url, tar_path.as_posix())
    tmp = _cache_dir() / f"_extract_{target.name}"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        with tarfile.open(tar_path) as tar:
            tar.extractall(tmp, filter="data")
        inner = next(p for p in tmp.iterdir() if p.is_dir())
        shutil.move(inner.as_posix(), target.as_posix())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        tar_path.unlink(missing_ok=True)


def convert_reference_checkpoint(path: Path) -> None:
    """Rewrite a reference (torch joeynmt) checkpoint at ``path`` as the
    port's: its model state without the ``pe`` tables and
    ``num_batches_tracked`` counters, no optimizer, scheduler or iterator
    state. It is read as tensors only (``weights_only``), as JAX reads it
    unless told to unpickle."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt["model_state"] if "model_state" in ckpt else ckpt
    state = {k: v for k, v in state.items()
             if k.split(".")[-1] not in ("pe", "num_batches_tracked")}
    save_checkpoint(path, {"model_state": state, "optimizer_state": None,
                           "scheduler_state": None, "train_iter_state": None,
                           "stats_state": ckpt.get("stats_state")})


def _ensure_native_ckpt(model_dir: Path, ckpt_name: str) -> None:
    """Convert the snapshot's checkpoint once: a port checkpoint has a
    ``stats_state`` entry (None after a conversion), a reference one not."""
    ckpt = model_dir / ckpt_name
    if not ckpt.exists():
        candidates = sorted(model_dir.glob("*.ckpt"))
        if not candidates:
            raise FileNotFoundError(f"no checkpoint found in {model_dir}")
        ckpt = candidates[0]
    if "stats_state" not in torch.load(ckpt, map_location="cpu", weights_only=True):
        logger.info("Converting reference checkpoint %s ...", ckpt)
        convert_reference_checkpoint(ckpt)


def load(name: str, model_dir: Optional[str] = None, ckpt_name: Optional[str] = None,
         **kwargs) -> TranslatorHubInterface:
    """A named zoo model, or ``local`` with ``model_dir``, as a hub
    interface; ``kwargs`` go to ``load_model_dir`` (``use_cuda=False`` runs
    on the CPU)."""
    if name == "local":
        if model_dir is None:
            raise ValueError("load('local') requires model_dir")
        snapshot = Path(model_dir)
        if ckpt_name:
            _ensure_native_ckpt(snapshot, ckpt_name)
    else:
        if name not in ENTRIES:
            raise ValueError(f"Unknown model {name}. Available: {sorted(ENTRIES)} or "
                             f"'local'.")
        snapshot = _download_and_extract(name)
        _ensure_native_ckpt(snapshot, ENTRIES[name][1])
        kwargs.setdefault("cfg_file", ENTRIES[name][2])
    return load_model_dir(snapshot, **kwargs)


def __getattr__(name):  # hubconf-style entry points: zoo.wmt14_deen(**kwargs)
    if name in ENTRIES:
        return lambda **kwargs: load(name, **kwargs)
    raise AttributeError(name)
