# coding: utf-8
"""``python -m joeys2t_torch`` end to end on the CPU, and the training loop.

The config is ``configs/synthetic_asr.yaml`` cut to test size
(``test_torch_data.tiny_cfg``: 2 + 2 layers, hidden 32, ``use_cuda: False``,
4 updates of 8 utterances, a validation every 2, greedy). ``train`` writes
the model directory; ``test -o`` and ``translate`` read it. Then, in
process: resuming from a checkpoint restores the model, optimizer,
scheduler, statistics and sampler state, and one more update continues
exactly as the trainer that wrote the checkpoint; and the loop steps each
kind of scheduler where the JAX loop steps it. The speech-translation leg
(``configs/synthetic_st.yaml`` cut the same way, BLEU, beam 5) trains from
the ASR model's encoder through ``load_encoder``. Unported options stop a
run before it loads data."""
import copy
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from joeys2t_torch.checkpoints import load_checkpoint
from joeys2t_torch.config import dump_yaml, parse_global_args, set_validation_args
from joeys2t_torch.prediction import prepare
from joeys2t_torch.training import TrainManager
from test_torch_data import REPO, few_threads, make_corpus, tiny_cfg  # noqa: F401

# few threads per process: the suite runs several test files at once
ENV = dict({k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
           OMP_NUM_THREADS="2")
pytestmark = pytest.mark.usefixtures("few_threads")


def cli(*args, stdin=None):
    return subprocess.run([sys.executable, "-m", "joeys2t_torch", *map(str, args)],
                          cwd=REPO, env=ENV, input=stdin, capture_output=True, text=True,
                          timeout=600, check=True)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    corpus = make_corpus(tmp / "data")
    cfg = tiny_cfg(corpus, tmp / "model")
    (tmp / "cfg.yaml").write_text(dump_yaml(cfg), encoding="utf-8")
    cli("train", tmp / "cfg.yaml")
    return tmp, corpus, cfg


def test_train_writes_the_model_directory(trained):
    tmp, _, _ = trained
    model_dir = tmp / "model"
    for name in ("config.yaml", "train.log", "trg_vocab.txt", "validations.txt",
                 "2.hyps", "4.hyps", "best.hyps.dev", "best.hyps.test"):
        assert (model_dir / name).is_file(), name
    lines = (model_dir / "validations.txt").read_text().splitlines()
    assert [line.split("\t")[0] for line in lines] == ["Steps: 2", "Steps: 4"]
    assert all(re.search(r"\twer: \d+\.\d+\t", line) for line in lines)
    for link in ("best.ckpt", "latest.ckpt"):
        assert (model_dir / link).is_symlink() and (model_dir / link).resolve().is_file()
    assert os.readlink(model_dir / "latest.ckpt") == "4.ckpt"
    ckpt = load_checkpoint(model_dir / "latest.ckpt")
    assert sorted(ckpt) == ["model_state", "optimizer_state", "scheduler_state",
                            "stats_state", "train_iter_state"]
    assert ckpt["stats_state"]["steps"] == 4
    assert all(v.dtype == torch.float32 for v in ckpt["model_state"].values())
    log = (model_dir / "train.log").read_text()
    assert "Training loop: 4 update(s)" in log and "Translations saved to" in log
    assert len((model_dir / "best.hyps.dev").read_text().splitlines()) == 8


def test_test_and_translate_read_the_model_directory(trained):
    tmp, corpus, _ = trained
    cli("test", tmp / "cfg.yaml", "-o", tmp / "out")
    for split in ("dev", "test"):
        assert len((tmp / f"out.{split}").read_text().splitlines()) == 8
    paths = [str(p) for p in sorted((corpus / "feats").glob("test-*.npy"))[:3]]
    out = cli("translate", tmp / "cfg.yaml", stdin="\n".join(paths) + "\n")
    lines = out.stdout.splitlines()
    assert len(lines) == 3 and all(lines)
    # the same model and features decode the same way in test and translate
    assert lines == (tmp / "out.test").read_text().splitlines()[:3]


def trainer(cfg, **train_overrides):
    """(trainer, train data, dev data) on the CPU from ``cfg``."""
    args = parse_global_args(copy.deepcopy(cfg), mode="train")
    args = dataclasses.replace(args, train=dataclasses.replace(args.train,
                                                               **train_overrides))
    args.model_dir.mkdir(exist_ok=True)
    model, spec, loss_fn, train_data, dev_data, _ = prepare(args, mode="train")
    tm = TrainManager(model, spec, loss_fn, args.train, seed=args.seed,
                      model_cfg=args.model, device=args.device, model_dir=args.model_dir,
                      task=args.task, dev_args=set_validation_args(args.test))
    return tm, train_data, dev_data


def no_dropout(cfg):
    cfg = copy.deepcopy(cfg)
    for side in ("encoder", "decoder"):
        cfg["model"][side]["dropout"] = 0.0
        cfg["model"][side]["embeddings"]["dropout"] = 0.0
    return cfg


def test_resume_restores_the_trainer(trained, tmp_path):
    _, corpus, cfg = trained
    cfg = dict(no_dropout(cfg), model_dir=str(tmp_path / "first"))
    cfg["training"].update(updates=3, validation_freq=3)
    first, train_data, dev_data = trainer(cfg)
    first.train_and_validate(train_data, dev_data)
    ckpt_path = tmp_path / "first" / "latest.ckpt"
    assert os.readlink(ckpt_path) == "3.ckpt"

    cfg2 = dict(cfg, model_dir=str(tmp_path / "second"))
    resumed, _, _ = trainer(cfg2, load_model=ckpt_path)
    saved = load_checkpoint(ckpt_path)
    for name, value in resumed.model.state_dict().items():
        assert torch.equal(value, first.model.state_dict()[name]), name
    a, b = resumed.optimizer.state_dict(), first.optimizer.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i, state in b["state"].items():
        for key, value in state.items():
            assert torch.equal(a["state"][i][key], value), (i, key)
    assert resumed.scheduler.state_dict() == first.scheduler.state_dict()
    assert resumed.stats.state_dict() == first.stats.state_dict() == saved["stats_state"]
    assert resumed.train_iter_state == first.batch_sampler.get_state()
    assert resumed.current_lr == first.current_lr

    batch = next(iter(train_data.make_iter(batch_size=8, seed=9)))
    for tm in (first, resumed):
        out = tm.train_batch(batch)
        assert out["stepped"]
    assert resumed.stats.steps == first.stats.steps == 4
    for name, value in resumed.model.state_dict().items():
        assert torch.equal(value, first.model.state_dict()[name]), name
    assert resumed.current_lr == first.current_lr


@pytest.mark.parametrize("error", [KeyboardInterrupt, RuntimeError])
def test_loop_saves_a_final_checkpoint_only_on_interrupt(trained, tmp_path, error):
    """An interrupt in the second update ends the loop with a final
    checkpoint of the one update that ran; any other exception propagates
    as raised, and no checkpoint is written after it."""
    _, _, cfg = trained
    cfg = dict(copy.deepcopy(cfg), model_dir=str(tmp_path / "model"))
    tm, train_data, dev_data = trainer(cfg)
    run, raised = tm._train_prepared, error("stop")

    def second_fails(prepared):
        if tm.stats.steps == 1:
            raise raised
        return run(prepared)

    tm._train_prepared = second_fails
    if error is KeyboardInterrupt:
        tm.train_and_validate(train_data, dev_data)
        assert os.readlink(tmp_path / "model" / "latest.ckpt") == "1.ckpt"
        assert load_checkpoint(tmp_path / "model" / "1.ckpt")["stats_state"]["steps"] == 1
    else:
        with pytest.raises(RuntimeError) as info:
            tm.train_and_validate(train_data, dev_data)
        assert info.value is raised and info.value.__context__ is None
        assert not list((tmp_path / "model").glob("*.ckpt"))


@pytest.mark.parametrize("scheduling,step_at", [("plateau", "validation"),
                                                ("decaying", "epoch"),
                                                ("warmupinversesquareroot", "step")])
def test_loop_steps_schedulers_where_jax_does(trained, tmp_path, scheduling, step_at):
    """24 utterances in batches of 8: epoch 1 holds updates 1-3, epoch 2
    update 4; validations after updates 2 and 4. ``step(epoch)`` runs at the
    start of each epoch (joeys2t_tpu/training.py:694-696), ``step_metric``
    after each validation (:916-918), ``step(steps)`` after each update,
    with ``step(0)`` once at construction."""
    _, _, cfg = trained
    cfg = dict(copy.deepcopy(cfg), model_dir=str(tmp_path / "model"))
    cfg["training"].update(scheduling=scheduling, patience=0, decaying_step_size=1)
    tm, train_data, dev_data = trainer(cfg)
    assert tm.scheduler_step_at == step_at
    calls = []
    step, step_metric = tm.scheduler.step, tm.scheduler.step_metric \
        if step_at == "validation" else None

    def record_step(n):
        calls.append(("step", n))
        return step(n)

    tm.scheduler.step = record_step
    if step_metric is not None:
        def record_metric(score):
            calls.append(("metric", round(score, 6)))
            return step_metric(score)
        tm.scheduler.step_metric = record_metric
    tm.train_and_validate(train_data, dev_data)
    wers = [float(re.search(r"wer: ([\d.]+)", line).group(1)) for line in
            (tmp_path / "model" / "validations.txt").read_text().splitlines()]
    expected = {"validation": [("metric", round(w, 6)) for w in wers],
                "epoch": [("step", 1), ("step", 2)],
                "step": [("step", n) for n in (1, 2, 3, 4)]}[step_at]
    assert calls == expected and len(wers) == 2
    rates = [float(re.search(r"LR: ([\d.]+)", line).group(1)) for line in
             (tmp_path / "model" / "validations.txt").read_text().splitlines()]
    assert np.isclose(rates[-1], tm.current_lr, rtol=1e-6)


@pytest.mark.parametrize("section,option", [
    ("testing", {"sacrebleu_cfg": {"tokenize": "ja-mecab"}}),
    ("testing", {"eval_metrics": ["bleu"], "sacrebleu_cfg": {"tokenize": None,
                                                             "trg_lang": "ja"}}),
    ("testing", {"eval_metrics": ["bleu"], "sacrebleu_cfg": {"tokenize": None,
                                                             "trg_lang": "ko"}}),
    ("testing", {"sacrebleu_cfg": {"tokenize": "spm"}}),
    ("testing", {"sacrebleu_cfg": {"tokenize": "flores200"}})])
@pytest.mark.parametrize("mode", ["train", "test", "translate"])
def test_runs_refuse_unported_options_before_loading_data(tmp_path, mode, section,
                                                          option):
    """An option the port does not have (a sacrebleu tokenizer that needs
    MeCab or a downloaded SentencePiece model) stops ``train``, ``test``
    and ``translate`` at once: here the data does not even exist."""
    from joeys2t_torch.prediction import test, translate
    from joeys2t_torch.training import train

    def merge(into, update):
        for key, value in update.items():
            if isinstance(value, dict):
                merge(into.setdefault(key, {}), value)
            else:
                into[key] = value

    cfg = tiny_cfg(tmp_path / "no_data", tmp_path / "model")
    merge(cfg[section], option)
    with pytest.raises(NotImplementedError):
        {"train": train, "test": test, "translate": translate}[mode](cfg)


def test_load_encoder_initializes_the_encoder(trained, tmp_path):
    """``load_encoder`` takes the encoder of a checkpoint with more layers:
    its first layer, subsampler and final norm load, the decoder keeps its
    own init."""
    tmp, _, cfg = trained
    cfg = dict(copy.deepcopy(cfg), model_dir=str(tmp_path / "model"))
    cfg["model"]["encoder"]["num_layers"] = 1
    source = tmp / "model" / "best.ckpt"
    cfg["training"]["load_encoder"] = str(source)
    tm, _, _ = trainer(cfg)
    saved = load_checkpoint(source)["model_state"]
    state = tm.model.state_dict()
    encoder = [k for k in state if k.startswith("encoder.")]
    assert any(k.startswith("encoder.layers.0.") for k in encoder)
    assert not any(k.startswith("encoder.layers.1.") for k in encoder)
    for name in encoder:
        assert torch.equal(state[name], saved[name]), name
    decoder = [k for k in state if k.startswith("decoder.layers.")]
    assert not any(torch.equal(state[k], saved[k]) for k in decoder if "weight" in k)


def st_cfg(data_dir, model_dir, encoder_ckpt):
    """``configs/synthetic_st.yaml`` at test size: its encoder as wide as
    ``tiny_cfg``'s but of 1 layer, loaded from ``encoder_ckpt``; a 1-layer
    decoder; 4 updates of 8 utterances, a validation every 2; BLEU and beam
    5 as configured."""
    from joeys2t_torch.config import load_config

    cfg = load_config(REPO / "configs" / "synthetic_st.yaml")
    cfg.update(use_cuda=False, fp16=False, model_dir=str(model_dir))
    for split in ("train", "dev", "test"):
        cfg["data"][split] = str(data_dir / split)
    cfg["data"]["trg"]["voc_file"] = str(data_dir / "trg_vocab.txt")
    cfg["testing"].update(batch_size=4)
    cfg["training"].update(updates=4, validation_freq=2, logging_freq=1, batch_size=8,
                           learning_rate_warmup=2, load_encoder=str(encoder_ckpt))
    for side, layers in (("encoder", 1), ("decoder", 1)):
        cfg["model"][side].update(num_layers=layers, hidden_size=32, ff_size=64,
                                  num_heads=2)
    cfg["model"]["encoder"]["conv_channels"] = 32
    cfg["model"]["decoder"]["embeddings"]["embedding_dim"] = 32
    return cfg


def test_speech_translation_leg_trains_from_the_asr_encoder(trained, tmp_path):
    tmp, _, _ = trained
    data = tmp_path / "st"
    subprocess.run([sys.executable, str(REPO / "scripts" / "generate_synthetic_st.py"),
                    "--out", str(data), "--train", "24", "--dev", "8", "--test", "8"],
                   check=True, capture_output=True, timeout=120)
    cfg = st_cfg(data, tmp_path / "model", tmp / "model" / "best.ckpt")
    assert cfg["testing"]["beam_size"] == 5 and cfg["testing"]["eval_metrics"] == ["bleu"]
    (tmp_path / "st.yaml").write_text(dump_yaml(cfg), encoding="utf-8")
    cli("train", tmp_path / "st.yaml")
    model_dir = tmp_path / "model"
    log = (model_dir / "train.log").read_text()
    assert "partial_load(encoder)" in log and "1 layers loaded, 1 layers ignored" in log
    lines = (model_dir / "validations.txt").read_text().splitlines()
    bleus = [float(re.search(r"\tbleu: ([\d.]+)\t", line).group(1)) for line in lines]
    assert len(bleus) == 2
    # early stopping on BLEU: the best checkpoint has the highest score
    best = 2 * (1 + bleus.index(max(bleus)))
    assert os.readlink(model_dir / "best.ckpt") == f"{best}.ckpt"
    assert "Beam search with beam_size=5" in log
    for split in ("dev", "test"):
        assert len((model_dir / f"best.hyps.{split}").read_text().splitlines()) == 8
