# coding: utf-8
"""The rest of the JAX package's tooling in the port, on the CPU.

- The profiler window (``profile_dir``, ``JOEYS2T_PROFILE_DIR``,
  ``JOEYS2T_PROFILE_WINDOW``) writes one Chrome trace of the updates it
  names, as JAX's writes its window.
- On-device SpecAugment: with zero masks the front end equals JAX's
  ``device_frontend(training=True)`` within the front end's tolerance (5e-4)
  and itself without SpecAugment bit for bit; with masks (its draws are
  not ``jax.random``'s) the masked widths, counts and starts lie within
  JAX's bounds, a masked value is the utterance mean JAX writes (1e-5), and
  frames past each length stay 0.
- mp3: ``read_mp3`` decodes a file the system libmp3lame wrote
  (tests/test_audio.py's fixture) to JAX's samples bit for bit, and its
  features match JAX's ``get_features`` within the front end's tolerance.
- The ``intl``, ``zh`` and ``char`` tokenizers against sacrebleu on mixed
  script (CJK, full-width forms, punctuation, symbols, digits), for WER and
  BLEU.
- The zoo over ``file://``: a named entry's tarball staged, renamed into
  the cache and its reference checkpoint converted once; the fallback
  source when the primary fails; ``load("local")``. Nothing is downloaded.
"""
import copy
import json
import shutil
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch

from joeys2t_torch.config import dump_yaml, load_config, parse_global_args
from joeys2t_torch.data.audio_io import get_features, read_mp3
from joeys2t_torch.ops.frontend import device_frontend
from joeys2t_torch.tokenizers import EvaluationTokenizer
from test_torch_data import few_threads  # noqa: F401 - fixture
from test_torch_mt import reverse_data_cfg, write_reverse_cut

REPO = Path(__file__).resolve().parents[1]
FRONT_END_TOL = 5e-4  # rfft against JAX's DFT matmul, after CMVN (ROADMAP §C)

pytestmark = pytest.mark.usefixtures("few_threads")


def tiny_reverse_cfg(tmp_path, **training):
    root = write_reverse_cut(tmp_path / "reverse", n_train=24, n_dev=4, n_test=4)
    cfg = load_config(REPO / "configs" / "transformer_reverse.yaml")
    cfg.update(use_cuda=False, model_dir=str(tmp_path / "model"), data=reverse_data_cfg(root))
    cfg["testing"].pop("load_model")
    cfg["testing"]["max_output_length"] = 6
    cfg["training"].update(dict(dict(updates=3, validation_freq=100, logging_freq=1,
                                     batch_size=8, batch_multiplier=1), **training))
    for side in ("encoder", "decoder"):
        cfg["model"][side].update(num_layers=1, hidden_size=16, ff_size=32, num_heads=2)
        cfg["model"][side]["embeddings"]["embedding_dim"] = 16
    return cfg


def train_tiny(cfg):
    from joeys2t_torch.prediction import prepare
    from joeys2t_torch.training import TrainManager

    Path(cfg["model_dir"]).mkdir(exist_ok=True)
    args = parse_global_args(copy.deepcopy(cfg), mode="train")
    model, spec, loss_fn, train_data, dev_data, _ = prepare(args, mode="train")
    tm = TrainManager(model, spec, loss_fn, args.train, seed=args.seed, model_cfg=args.model,
                      device="cpu", model_dir=args.model_dir, task="MT", dev_args=args.test)
    tm.train_and_validate(train_data, dev_data)
    return tm, model


# ---------------------------------------------------------------- profiler
@pytest.mark.parametrize("from_env", [False, True])
def test_profile_window_writes_a_trace(tmp_path, monkeypatch, from_env):
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("JOEYS2T_PROFILE_WINDOW", "1,2")
    if from_env:
        monkeypatch.setenv("JOEYS2T_PROFILE_DIR", str(trace_dir))
        cfg = tiny_reverse_cfg(tmp_path, profile_dir=str(tmp_path / "ignored"))
    else:
        monkeypatch.delenv("JOEYS2T_PROFILE_DIR", raising=False)
        cfg = tiny_reverse_cfg(tmp_path, profile_dir=str(trace_dir))
    tm, _ = train_tiny(cfg)
    assert tm.stats.steps == 3
    assert sorted(p.name for p in trace_dir.iterdir()) == ["trace.1-2.json"]
    events = json.loads((trace_dir / "trace.1-2.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names or "aten::addmm" in names
    assert not (tmp_path / "ignored").exists()


# ------------------------------------------------------------- SpecAugment
def waves(seed=0):
    rng = np.random.RandomState(seed)
    lengths = np.array([32000, 17000, 24321, 9000])
    out = np.zeros((4, 32000), np.float32)
    for i, length in enumerate(lengths):
        envelope = np.repeat(np.exp(rng.uniform(3, 9, size=length // 800 + 1)), 800)
        out[i, :length] = envelope[:length] * rng.randn(length)
    return out, lengths


def test_specaugment_without_masks_is_the_front_end():
    import jax.numpy as jnp

    from joeys2t_tpu.ops.frontend import device_frontend as jax_frontend

    w, lengths = waves()
    none = (0, 27, 0, 100, 1.0)
    plain, frames = device_frontend(torch.tensor(w), torch.tensor(lengths))
    feats, _ = device_frontend(torch.tensor(w), torch.tensor(lengths), training=True,
                               specaugment=none, generator=torch.Generator().manual_seed(0))
    assert torch.equal(plain, feats)
    ref, ref_frames = jax_frontend(jnp.asarray(w), jnp.asarray(lengths, jnp.int32),
                                   training=True, specaugment=none)
    np.testing.assert_array_equal(frames.numpy(), np.asarray(ref_frames))
    np.testing.assert_allclose(feats.numpy(), np.asarray(ref), atol=FRONT_END_TOL, rtol=1e-4)


def test_specaugment_masks_keep_jax_bounds():
    import jax
    import jax.numpy as jnp

    from joeys2t_tpu.ops.frontend import device_frontend as jax_frontend

    w, lengths = waves(1)
    spec = (2, 27, 2, 40, 0.2)
    plain, frames = device_frontend(torch.tensor(w), torch.tensor(lengths))
    ref, _ = jax_frontend(jnp.asarray(w), jnp.asarray(lengths, jnp.int32),
                          rng=jax.random.PRNGKey(3), training=True, specaugment=spec)
    ref, ref_plain = np.asarray(ref), np.asarray(jax_frontend(
        jnp.asarray(w), jnp.asarray(lengths, jnp.int32))[0])
    gen = torch.Generator().manual_seed(0)
    freq_cols, time_rows = [], []
    for draw in range(20):
        feats, _ = device_frontend(torch.tensor(w), torch.tensor(lengths), training=True,
                                   specaugment=spec, generator=gen)
        changed = (feats != plain).numpy()
        for b, n in enumerate(frames.tolist()):
            value = plain[b, :n].mean()
            mask_value = np.unique(feats[b][torch.tensor(changed[b])].numpy())
            assert mask_value.size <= 1
            if mask_value.size:
                np.testing.assert_allclose(mask_value[0], value.item(), atol=1e-5)
                if draw == 0:  # JAX writes the same value where it masks
                    jax_masked = ref[b, :n] != ref_plain[b, :n]
                    assert jax_masked.any()
                    np.testing.assert_allclose(ref[b, :n][jax_masked], value.item(),
                                               atol=FRONT_END_TOL)
            assert (feats[b, n:] == 0).all()
            cols = changed[b, :n].all(axis=0)  # frequency masks cover every frame
            rows = changed[b, :n].all(axis=1)
            max_t = min(40, int(np.floor(n * 0.2)))
            assert cols.sum() <= 2 * 26 and rows.sum() <= 2 * (max_t - 1)
            freq_cols.append(cols.sum())
            time_rows.append(rows.sum())
    assert np.mean(freq_cols) > 5 and np.mean(time_rows) > 1  # the masks do fire


# ----------------------------------------------------------------------- mp3
def test_mp3_matches_jax(tmp_path):
    from joeys2t_tpu.data.audio_io import get_features as jax_get_features
    from joeys2t_tpu.data.audio_io import read_mp3 as jax_read_mp3
    from test_audio import _encode_mp3_with_lame

    w, lengths = waves(2)
    if not _encode_mp3_with_lame(w[0][:lengths[0]], 16000, tmp_path / "a.mp3"):
        pytest.skip("libmp3lame is not installed to write the fixture")
    samples, rate = read_mp3(tmp_path / "a.mp3")
    ref, ref_rate = jax_read_mp3(tmp_path / "a.mp3")
    assert rate == ref_rate == 16000 and samples.dtype == np.float32
    np.testing.assert_array_equal(samples, ref)
    assert abs(len(samples) - lengths[0]) < 0.25 * 16000  # codec delay and padding
    port, jax_feats = get_features(tmp_path, "a.mp3"), jax_get_features(tmp_path, "a.mp3")
    assert port.shape == jax_feats.shape and port.shape[1] == 80
    assert np.abs(port - jax_feats).max() <= FRONT_END_TOL


# -------------------------------------------------------------- tokenizers
MIXED = ["Hello, world! 3.14 is π; 1,000 dollars – $5 costs €3.",
         "我爱北京天安门。你好，世界！ABC 123.", "日本語のテキスト、です。Ｆｕｌｌ　ｗｉｄｔｈ ＡＢＣ",
         "(a) [b] {c} 'q' \"d\" 5-3 x-y ½ ² © ™ ∑ ≥ ← ★ ☺",
         "…etc., — « guillemets » ¿qué? ¡sí! 1.5% #hash @at 2020.",
         "한국어 텍스트. ไทย ภาษา! العربية؟ 𠀀𠀁 ⺀ ㄅ ㈠ ㌀ ☂ ✂ ︐ ﹐ ‐ ‒"]


@pytest.mark.parametrize("tokenize", ["intl", "zh"])
def test_evaluation_tokenizers_match_sacrebleu(tokenize):
    from joeys2t_tpu.tokenizers import EvaluationTokenizer as JaxEvaluationTokenizer

    for lowercase, no_punc in ((False, False), (True, True)):
        port = EvaluationTokenizer(lowercase=lowercase, tokenize=tokenize, no_punc=no_punc)
        ref = JaxEvaluationTokenizer(lowercase=lowercase, tokenize=tokenize, no_punc=no_punc)
        for line in MIXED:
            assert port(line) == ref(line), line


@pytest.mark.parametrize("cfg", [{"tokenize": "intl"}, {"tokenize": "zh"},
                                 {"tokenize": "char"}, {"trg_lang": "zh"}])
def test_bleu_tokenizers_match_sacrebleu(cfg):
    from joeys2t_torch.metrics import bleu
    from joeys2t_tpu.metrics import bleu as jax_bleu

    hyps = MIXED[1:] + MIXED[:1]
    refs = [line.replace("世界", "世 界").replace(",", "") for line in MIXED]
    hyps = [h if i % 2 else r for i, (h, r) in enumerate(zip(hyps, refs))]
    assert bleu(hyps, refs, **cfg) == pytest.approx(jax_bleu(hyps, refs, **cfg), abs=1e-9)


def test_mecab_tokenizers_stay_refused():
    from joeys2t_torch.metrics import bleu

    with pytest.raises(NotImplementedError, match="MeCab"):
        EvaluationTokenizer(tokenize="ja-mecab")
    with pytest.raises(NotImplementedError, match="ja-mecab"):
        bleu(["a"], ["a"], trg_lang="ja")


# ---------------------------------------------------------------------- zoo
def _reference_snapshot(tmp_path, name="wmt14_deen"):
    """A snapshot directory as the zoo publishes one: the config names its
    publisher's paths, and the checkpoint is a reference one (its ``pe``
    tables and counters, no ``stats_state``)."""
    from joeys2t_torch.prediction import prepare

    cfg = tiny_reverse_cfg(tmp_path)
    snap = tmp_path / name
    snap.mkdir()
    cfg["model_dir"] = str(snap)
    model = prepare(parse_global_args(copy.deepcopy(cfg), mode="train"), mode="train")[0]
    state = dict(model.state_dict(), **{"encoder.pe.pe": torch.zeros(1, 30, 16),
                                        "decoder.pe.pe": torch.zeros(1, 30, 16)})
    torch.save({"model_state": state, "steps": 3, "best_ckpt_score": 1.5},
               snap / "avg5.ckpt")
    cfg["model_dir"] = f"models/{name}"
    cfg["testing"]["load_model"] = f"models/{name}/avg5.ckpt"
    for side in ("src", "trg"):
        cfg["data"][side]["voc_file"] = f"models/{name}/{side}_vocab.txt"
    (snap / "config.yaml").write_text(dump_yaml(cfg), encoding="utf-8")
    return snap, model


def test_zoo_fetches_over_file_url_and_converts_once(tmp_path, monkeypatch):
    from joeys2t_torch import zoo

    snap, model = _reference_snapshot(tmp_path)
    served = tmp_path / "served"
    served.mkdir()
    with tarfile.open(served / "wmt14_deen.tar.gz", "w:gz") as tar:
        tar.add(snap, arcname="wmt14_deen")
    cache = tmp_path / "cache"
    cache.mkdir()
    monkeypatch.setattr(zoo, "_cache_dir", lambda: cache)
    monkeypatch.setattr(zoo, "BASE_URL", served.as_uri())
    hf_calls = []

    def no_network(base, target):
        hf_calls.append(base)
        raise RuntimeError("offline")

    monkeypatch.setattr(zoo, "_fetch_hf_snapshot", no_network)
    hub = zoo.load("wmt14_deen", use_cuda=False)
    assert hf_calls == [] and sorted(p.name for p in cache.iterdir()) == ["wmt14_deen"]
    ckpt = torch.load(cache / "wmt14_deen" / "avg5.ckpt", weights_only=True)
    assert "encoder.pe.pe" not in ckpt["model_state"] and ckpt["optimizer_state"] is None
    for name, value in model.state_dict().items():
        assert torch.equal(hub.model.state_dict()[name], value), name
    lines = ["3 5 7", "2 4"]
    out = hub.generate(lines)
    assert len(out) == 2 and all(isinstance(t, str) for t in out)
    # the cache answers the second load; the local snapshot decodes alike
    (served / "wmt14_deen.tar.gz").unlink()
    assert zoo.load("wmt14_deen", use_cuda=False).generate(lines) == out
    assert zoo.load("local", model_dir=str(snap), ckpt_name="avg5.ckpt",
                    use_cuda=False).generate(lines) == out


def test_zoo_falls_back_to_the_other_source(tmp_path, monkeypatch):
    from joeys2t_torch import zoo

    snap, _ = _reference_snapshot(tmp_path, "mustc_mt")
    cache = tmp_path / "cache"
    cache.mkdir()
    monkeypatch.setattr(zoo, "_cache_dir", lambda: cache)
    monkeypatch.setattr(zoo, "BASE_URL", (tmp_path / "nothing_here").as_uri())
    monkeypatch.setattr(zoo, "_fetch_hf_snapshot",
                        lambda base, target: shutil.copytree(snap, target))
    assert zoo._download_and_extract("mustc_v2_ende_mt") == cache / "mustc_v2_ende_mt"
    assert sorted(p.name for p in cache.iterdir()) == ["mustc_v2_ende_mt"]
    monkeypatch.setattr(zoo, "_fetch_hf_snapshot",
                        lambda base, target: (target.mkdir(), (target / "x").touch()))
    with pytest.raises(RuntimeError, match="any source"):
        zoo._download_and_extract("wmt14_ende")
    assert sorted(p.name for p in cache.iterdir()) == ["mustc_v2_ende_mt"]
