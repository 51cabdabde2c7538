# coding: utf-8
"""Data-parallel validation, test and training loop on the CPU: two gloo
ranks (subprocesses, as in tests/test_torch_ddp.py, each wait bounded by
its ``TIMEOUT``) against one process and the JAX package.

- Sharded ``predict`` of the synthetic dev set (8 utterances in batches of
  3, so rank 0 decodes batches 0 and 2 and rank 1 batch 1), greedy with
  per-token scores and beam 5 with 2 hypotheses an utterance: both ranks
  merge to the tokens, hypotheses and scores of a single-process
  ``predict`` and of the JAX package's, in dataset order; the summed loss
  to 1e-5 relative.
- Lockstep: token batches make the ranks' shards give unequal batch counts;
  both ranks end the epoch at the same update, where the shorter shard
  ends.
- ``python -m joeys2t_torch train <cfg> -d`` under torchrun's variables,
  ``use_cuda: False``, at dropout 0 and without SpecAugment (it draws from
  numpy's global RNG in each rank's own pipeline, so its stream differs
  from one process's): rank 0 alone writes the model directory, and the
  closing ``test`` writes what a single-process run with the same global
  batches (twice the batch size) writes.
"""
import copy
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from joeys2t_torch.config import dump_yaml, load_config, parse_special_symbols
from joeys2t_torch.convert import flax_params_to_state_dict
from joeys2t_torch.data.loader import load_data
from joeys2t_torch.data.samplers import ShardedSubsetSampler, TokenBatchSampler
from test_torch_data import REPO, few_threads, make_corpus, tiny_cfg  # noqa: F401
from test_torch_ddp import launch, port_predict
from test_torch_prediction import BEAM, jax_side
from test_torch_prediction import setup  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("few_threads")
WORKER = REPO / "tests" / "test_torch_ddp.py"
PREDICT = [{"return_prob": "hyp"}, dict(BEAM, return_prob="hyp", n_best=2)]


@pytest.fixture(scope="module")
def sharded(setup, tmp_path_factory):  # noqa: F811
    """Rank 0's and rank 1's merged ``predict`` of each of ``PREDICT``."""
    tmp, _, cfg, params = setup
    cfg = copy.deepcopy(cfg)
    cfg["testing"]["batch_size"] = 3
    work = tmp_path_factory.mktemp("predict")
    torch.save({"cfg": cfg, "state": flax_params_to_state_dict(params),
                "variants": PREDICT}, work / "job.pt")
    launch([WORKER, "predict", work / "job.pt", work], work)
    return cfg, params, [torch.load(work / f"predict{r}.pt", weights_only=False)
                         for r in range(2)]


@pytest.mark.parametrize("variant", [0, 1], ids=["greedy", "beam5"])
def test_sharded_predict_merges_to_one_process_and_jax(sharded, variant):
    cfg, params, ranks = sharded
    testing = PREDICT[variant]
    one = port_predict(cfg, flax_params_to_state_dict(params), testing)
    ref = jax_side(cfg, params, **testing)
    n = 8 * testing.get("n_best", 1)
    for got in (r[variant] for r in ranks):
        scores, refs, hyps, decoded, seq_scores = got
        assert len(decoded) == n and decoded == one[3] == ref[3]  # token for token
        assert hyps == one[2] == ref[2] and refs == one[1] == ref[1]
        assert scores["wer"] == one[0]["wer"] == ref[0]["wer"]
        for name in ("loss", "ppl", "acc"):
            assert math.isfinite(scores[name])
            assert abs(scores[name] - one[0][name]) <= 1e-5 * abs(one[0][name]), name
            assert abs(scores[name] - ref[0][name]) <= 1e-5 * abs(ref[0][name]), name
        assert len(seq_scores) == n
        for a, b, c in zip(seq_scores, one[4], ref[4]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(c, np.float64),
                                       rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("ddp_corpus"))


def loop_cfg(corpus, model_dir, **training) -> dict:
    """tiny_cfg at dropout 0 without SpecAugment."""
    cfg = tiny_cfg(corpus, model_dir)
    del cfg["data"]["src"]["tokenizer_cfg"]["specaugment"]
    for side in ("encoder", "decoder"):
        cfg["model"][side]["dropout"] = 0.0
        cfg["model"][side]["embeddings"]["dropout"] = 0.0
    cfg["training"].update(training)
    return cfg


def token_batch_counts(cfg, batch_size: int):
    """Each rank's number of token batches in the first epoch."""
    data = copy.deepcopy(cfg["data"])
    data["special_symbols"] = parse_special_symbols(data.get("special_symbols", {}))
    _, _, train, _, _ = load_data(data, ["train"], task="S2T")
    counts = []
    for rank in range(2):
        train.reset_indices()
        sampler = TokenBatchSampler(ShardedSubsetSampler(train, shuffle=True, seed=42,
                                                         num_replicas=2, rank=rank),
                                    batch_size=batch_size, drop_last=False, seed=42)
        sampler.set_seed(43)  # the trainer's seed + epoch 1
        counts.append(sum(1 for _ in sampler))
    return counts


def test_lockstep_epoch_ends_together(corpus, tmp_path):
    """The ranks' shards give unequal numbers of token batches; both ranks
    take as many updates as the shorter shard has batches, and the longer
    one's extra batch is dropped."""
    cfg = loop_cfg(corpus, tmp_path / "model", batch_type="token", epochs=1,
                   updates=1000, validation_freq=1000, logging_freq=1)
    for batch_size in range(1200, 3000, 100):
        counts = token_batch_counts(cfg, batch_size)
        if counts[0] != counts[1]:
            break
    assert counts[0] != counts[1], "no token batch size gives unequal shards"
    cfg["training"]["batch_size"] = batch_size
    (tmp_path / "model").mkdir()
    torch.save(cfg, tmp_path / "job.pt")
    launch([WORKER, "lockstep", tmp_path / "job.pt", tmp_path], tmp_path)
    ranks = [torch.load(tmp_path / f"lockstep{r}.pt") for r in range(2)]
    assert ranks[0]["steps"] == ranks[1]["steps"] == min(counts)
    # each rank produced its own batches up to the step where one ran out
    assert sorted(r["local_batches"] for r in ranks) == [min(counts), min(counts) + 1]


def run_cli(cfg, path, *flags, ddp=False):
    path.write_text(dump_yaml(cfg), encoding="utf-8")
    argv = ["-m", "joeys2t_torch", "train", path, *flags]
    if ddp:
        launch(argv, path.parent)
        return
    env = dict({k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
               OMP_NUM_THREADS="2")
    subprocess.run([sys.executable, *map(str, argv)], cwd=REPO, check=True, timeout=600,
                   capture_output=True, env=env)


def test_cli_data_parallel_train_writes_once_and_tests_like_one_process(corpus, tmp_path):
    ddp_dir, one_dir = tmp_path / "ddp", tmp_path / "one"
    cfg = loop_cfg(corpus, ddp_dir, batch_size=4, updates=3)
    run_cli(cfg, tmp_path / "ddp.yaml", "-d", ddp=True)
    one = loop_cfg(corpus, one_dir, batch_size=8, updates=3)
    run_cli(one, tmp_path / "one.yaml")
    for name in ("best.hyps.dev", "best.hyps.test", "2.hyps"):
        assert (ddp_dir / name).read_text() == (one_dir / name).read_text(), name
    ddp_valid = (ddp_dir / "validations.txt").read_text().splitlines()
    one_valid = (one_dir / "validations.txt").read_text().splitlines()
    assert len(ddp_valid) == len(one_valid) == 1  # one report, from rank 0
    fields = [dict(f.split(": ") for f in v[0].split("\t") if ": " in f)
              for v in (ddp_valid, one_valid)]
    assert sorted(fields[0]) == sorted(fields[1])
    for key, value in fields[1].items():  # the 5-decimal loss: summation order
        assert abs(float(fields[0][key]) - float(value)) <= 1e-5 * max(abs(float(value)),
                                                                       1.0), key
    assert fields[0]["Steps"] == "2" and fields[0]["wer"] == fields[1]["wer"]
    log = (ddp_dir / "train.log").read_text()
    assert log.count("Training loop: 3 update(s)") == 1 and "[rank 1]" not in log
    assert "data-parallel ranks: 2" in log and "effective batch size: 8" in log
    assert log.count("Checkpoint saved in") == \
        (one_dir / "train.log").read_text().count("Checkpoint saved in")
    for ckpt in ("best.ckpt", "latest.ckpt"):
        state = torch.load(ddp_dir / ckpt, weights_only=True)["model_state"]
        assert not any(k.startswith("module.") for k in state)


def test_cli_refuses_data_parallel_without_a_group_on_the_cpu(corpus, tmp_path):
    """``-d`` with ``use_cuda: False`` and no torchrun variables raises
    rather than train as one process; ``translate -d`` raises."""
    from joeys2t_torch.__main__ import main
    from joeys2t_torch.config import ConfigurationError

    path = tmp_path / "cfg.yaml"
    path.write_text(dump_yaml(loop_cfg(corpus, tmp_path / "model")), encoding="utf-8")
    for mode in ("train", "translate"):
        with pytest.raises(ConfigurationError):
            main([mode, str(path), "-d"])
    assert not (tmp_path / "model").exists()
    assert load_config(path)["use_cuda"] is False
