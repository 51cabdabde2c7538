# coding: utf-8
"""Every key that the JAX package reads by name is read by the port or
refused by name: a key dropped without a word (as ``remat``,
``embeddings.load_pretrained`` and ``attention_impl`` once were) fails here.

The keys come from ``ast`` over the JAX package's reading sites
(joeys2t_tpu/config.py, models/model.py, prediction.py, training.py,
optim.py, tokenizers.py, data/*.py): the string constant of a ``.get``,
``.pop`` or ``.setdefault`` call, of a subscript that is read, and the
left side of an ``in`` test. The port's are found the same way over every
module of joeys2t_torch. A few of JAX's names are not configuration keys
(``NOT_CONFIG``); one is read under a computed name (``COMPUTED``); the
rest must be read by the port. ``model_parallel``, ``sequence_parallel``,
``pipeline_parallel`` and ``pipeline_microbatches`` are read (tensor and
pipeline parallelism); ``BAD_VALUES`` holds the values of them JAX refuses
by name, which the port refuses by name too. ``momentum``, ``freeze``,
``profile_dir`` (with JAX's ``JOEYS2T_PROFILE_*`` knobs) and
``return_attention`` are read since the port has sgd's momentum, ``freeze``,
the profiler window and returned attention.

Keys found (197; the list is held here, so a new key read by JAX shows):
JOEYS2T_BEAM_REORDER, JOEYS2T_PROFILE_DIR, JOEYS2T_PROFILE_WINDOW,
activation, adam_betas, alpha, attention, attention_impl, aux_loss,
batch_multiplier, batch_size, batch_type, beam_alpha, beam_reorder,
beam_size, best, best_ckpt_iter, best_ckpt_score, bidirectional, bos_id,
bos_token, bpe_type, cache_cross_int8, cache_self_int8, clip_grad_norm,
clip_grad_val, cmvn, codes, conv_channels, conv_kernel_sizes, conv_norm,
ctc_weight, data, dataset_cfg, dataset_type, decay_length, decay_rate,
decaying_step_size, decoder, decrease_factor, deleted,
depthwise_conv_kernel_size, dev, dropout, early_stopping_metric, embedding,
embedding_dim, embeddings, encoder, eos_id, eos_token, epochs, eval,
eval_metric, eval_metrics, factor, feature_dtype, ff_size, fp16, freeze,
gamma, generate_unk, glossaries, has_prompt, hf_split, hidden_dropout,
hidden_size, in_channels, init_hidden, initializer, input_feeding,
joeynmt_version, keep_best_ckpts, keep_last_ckpts, label_smoothing, lang,
lang_tags, layer_norm, layerscale, learning_rate, learning_rate_decay,
learning_rate_decay_length, learning_rate_factor, learning_rate_min,
learning_rate_peak, learning_rate_warmup, level, load_decoder, load_encoder,
load_model, load_pretrained, logging_freq, loss, loss_fn, lowercase, lut,
macaron, max_length, max_output_length, min_length, min_output_length,
min_rate, mode, model, model_dir, model_file, model_parallel, model_state,
moment_dtype, momentum, n_best, n_frames, name, nbest_size, no_punc,
no_repeat_ngram_size, normalization, normalize, num_bad, num_experts,
num_freq, num_heads, num_layers, num_workers, optimizer, optimizer_state,
pad_id, pad_token, params, patience, peak_rate, pipe, pipeline_microbatches,
pipeline_parallel, pretokenizer, print_valid_sents, profile_dir,
random_dev_subset, random_seed, random_train_subset, rate, remat,
repetition_penalty, reset_best_ckpt, reset_iter_state, reset_optimizer,
reset_scheduler, return_attention, return_prob, rnn_type, sacrebleu,
sacrebleu_cfg, sample_dev_subset, sample_train_subset, scheduler_state,
scheduling, sep_id, sep_token, separator, sequence_parallel, shuffle, spec,
specaugment, special_symbols, split, src, src_embed, src_length, src_mask,
src_prompt_mask, stats_state, step, step_size, steps, stream, subsample,
task, test, testing, tied_embeddings, tied_softmax, tokenize, tokenizer_cfg,
tokenizer_type, total_correct, total_tokens, train, train_iter_state,
training, trg, trg_embed, trg_input, trg_length, trg_mask, trg_prompt,
trg_prompt_mask, type, unk_id, unk_token, updates, use_cuda,
validation_freq, voc_file, warmup, weight_decay."""
import ast
import re
from pathlib import Path

import pytest

from joeys2t_torch.config import ConfigurationError, parse_test_args, parse_train_args

REPO = Path(__file__).resolve().parents[1]
JAX_SITES = ["config.py", "models/model.py", "prediction.py", "training.py", "optim.py",
             "tokenizers.py", "data/*.py"]
NOT_CONFIG = {  # names JAX reads that no config holds
    "aux_loss": "a flax variable collection (training.py:502-506)",
    "deleted": "text of a JAX runtime error (training.py:840)",
    "embedding": "a leaf of the flax parameter tree (prediction.py:558)",
    "lut": "a node of the flax parameter tree (prediction.py:558)",
    "trg_embed": "a node of the flax parameter tree (prediction.py:566)",
    "pipe": "a JAX mesh axis (training.py:255)",
}
COMPUTED = {  # key -> the port's source that reads it under a computed name
    "trg_prompt": ("data/datasets.py", 'f"{lang}_prompt"'),
}
BAD_VALUES = {  # read keys whose values JAX refuses by name: the section, the error
    "model_parallel": ({"model_parallel": 0}, ConfigurationError),
    "pipeline_parallel": ({"pipeline_parallel": 0}, ConfigurationError),
    "pipeline_microbatches": ({"pipeline_microbatches": -1}, ConfigurationError),
}


def read_keys(files):
    """The string keys read by name in ``files``."""
    keys = set()
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
            key = None
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("get", "pop", "setdefault") and node.args):
                key = node.args[0]
            elif isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
                key = node.slice
            elif isinstance(node, ast.Compare) and isinstance(node.ops[0],
                                                                (ast.In, ast.NotIn)):
                key = node.left
            if isinstance(key, ast.Constant) and isinstance(key.value, str):
                keys.add(key.value)
    return keys


def jax_keys():
    return read_keys(sorted(p for site in JAX_SITES
                            for p in (REPO / "joeys2t_tpu").glob(site)))


def port_keys():
    return read_keys(sorted((REPO / "joeys2t_torch").rglob("*.py")))


def test_the_recorded_list_is_what_jax_reads():
    recorded = re.split(r"[\s,]+", __doc__.split("shows):")[1].strip().rstrip("."))
    assert sorted(jax_keys()) == sorted(recorded)


def test_every_jax_key_is_read_or_refused():
    missing = jax_keys() - port_keys() - set(NOT_CONFIG) - set(COMPUTED)
    assert not missing, f"JAX reads these keys, the port does not: {sorted(missing)}"
    for key, (module, source) in COMPUTED.items():
        assert source in (REPO / "joeys2t_torch" / module).read_text(encoding="utf-8"), key


def train_section(**extra):
    return dict({"batch_size": 4, "optimizer": "adam"}, **extra)


@pytest.mark.parametrize("key", sorted(BAD_VALUES))
def test_refused_keys_are_named(key):
    section, error = BAD_VALUES[key]
    with pytest.raises(error, match=key):
        parse_train_args(train_section(**section))


def test_parallel_keys_are_read_as_jax_reads_them():
    """The four keys reach the training config (the model section's
    ``sequence_parallel`` the trainer), and tensor with pipeline parallelism
    is refused by name, as joeys2t_tpu/config.py:287-289 refuses it."""
    args = parse_train_args(train_section(model_parallel=2, pipeline_microbatches=4))
    assert (args.model_parallel, args.pipeline_parallel, args.pipeline_microbatches) \
        == (2, 1, 4)
    assert parse_train_args(train_section(pipeline_parallel=2)).pipeline_parallel == 2
    with pytest.raises(ConfigurationError, match="model_parallel"):
        parse_train_args(train_section(model_parallel=2, pipeline_parallel=2))
    assert "sequence_parallel" in port_keys()


@pytest.mark.parametrize("env,yaml,expected", [
    (None, {}, "auto"), (None, {"beam_reorder": "physical"}, "physical"),
    ("lazy", {"beam_reorder": "physical"}, "lazy"), ("PHYSICAL", {}, "physical")])
def test_beam_reorder_environment_override(monkeypatch, env, yaml, expected):
    """``JOEYS2T_BEAM_REORDER`` overrides the YAML when the `testing`
    section is parsed (joeys2t_tpu/config.py:409-412)."""
    if env is None:
        monkeypatch.delenv("JOEYS2T_BEAM_REORDER", raising=False)
    else:
        monkeypatch.setenv("JOEYS2T_BEAM_REORDER", env)
    assert parse_test_args(dict(yaml)).beam_reorder == expected


def test_bad_beam_reorder_from_the_environment_is_refused(monkeypatch):
    from joeys2t_torch.config import ConfigurationError

    monkeypatch.setenv("JOEYS2T_BEAM_REORDER", "sideways")
    with pytest.raises(ConfigurationError):
        parse_test_args({})
