# coding: utf-8
"""The port's spans (``joeys2t_torch.tracing``) and the decode loops' host
clocks, on the CPU.

Without a profiler ``span`` is one shared no-op and the results are the
bits they are under a profiler; under ``torch.profiler`` each span lands
where the program's layers meet: a greedy step with its read-back inside the
loop's span, a beam step's scores and selection, an update's forward and
backward and its optimizer. Model: ``test_torch_train``'s (hidden 128, 2
heads, 2 + 1 layers, 40 ids), dropout 0, the port alone."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from joeys2t_torch import tracing
from joeys2t_torch.config import SpecialSymbols, parse_train_args
from joeys2t_torch.losses import build_loss_function
from joeys2t_torch.models import build_model
from joeys2t_torch.search import beam_search, search, transformer_greedy
from joeys2t_torch.serving import Transcriber
from joeys2t_torch.training import TrainManager
from joeys2t_torch.vocabulary import Vocabulary
from test_torch_train import TOKENS, TRAINING, micro_batches, model_cfg, port_batch

MAX_LEN = 7


def profiled(fn):
    """``fn()`` under a CPU ``torch.profiler``: its result and the host's
    events."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def ranges(events, name):
    return [(e.time_range.start, e.time_range.end) for e in events if e.name == name]


def inside(inner, outer):
    """The ranges of ``inner`` that lie within each range of ``outer``."""
    return [[r for r in inner if s <= r[0] and r[1] <= e] for s, e in outer]


@pytest.fixture(scope="module")
def asr():
    vocab = Vocabulary(TOKENS, SpecialSymbols())
    model, spec = build_model(model_cfg(), trg_vocab=vocab, device="cpu",
                              generator=torch.Generator().manual_seed(5))
    model.eval()
    src, lengths, _, _ = micro_batches(1, seed=4)[0]
    with torch.no_grad():
        enc, _, mask = model.encode(torch.tensor(src), torch.tensor(lengths))
    return dict(model=model, spec=spec, vocab=vocab, enc=enc, mask=mask)


def greedy(asr, stats=None):
    return transformer_greedy(asr["model"], asr["spec"], asr["enc"], asr["mask"], MAX_LEN,
                              device="cpu", stats=stats, return_prob="hyp")


def beam(asr, stats=None):
    return beam_search(asr["model"], asr["spec"], asr["enc"], None, asr["mask"], 3, MAX_LEN,
                       1.0, n_best=2, device="cpu", stats=stats, return_prob="hyp")


def test_the_profiler_flag_exists():
    """``span`` reads this flag of torch's: a torch that renamed it would
    leave tracing off without a word."""
    from torch.autograd import profiler

    assert profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiler._is_profiler_enabled is True
    assert profiler._is_profiler_enabled is False


def test_span_is_the_shared_noop_without_a_profiler():
    off = tracing.span("joeys2t.request", "1")
    assert off is tracing.span("joeys2t.decode") is tracing._OFF
    with off as entered:
        assert entered is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = tracing.span("joeys2t.test", "7")
        assert on is not tracing._OFF
        with on:
            pass
    assert [e.name for e in prof.events()].count("joeys2t.test") == 1


@pytest.mark.parametrize("decode", [greedy, beam], ids=["greedy", "beam"])
def test_decoding_is_bit_identical_under_the_profiler(asr, decode):
    plain = decode(asr)
    traced, _ = profiled(lambda: decode(asr))
    np.testing.assert_array_equal(plain[0], traced[0])
    assert plain[1].tobytes() == traced[1].tobytes()


def trainer():
    """A ``TrainManager`` with an update every micro-batch."""
    vocab = Vocabulary(TOKENS, SpecialSymbols())
    model, spec = build_model(model_cfg(), trg_vocab=vocab, device="cpu",
                              generator=torch.Generator().manual_seed(3))
    args = parse_train_args(dict(TRAINING, batch_multiplier=1))
    return TrainManager(model, spec, build_loss_function(args, spec), args, device="cpu")


def test_update_gradients_are_bit_identical_under_the_profiler():
    def update():
        tm = trainer()
        seen, apply = {}, tm.apply_accum

        def capture():
            seen.update({n: p.grad.clone() for n, p in tm.model.named_parameters()})
            apply()

        tm.apply_accum = capture
        tm.train_batch(port_batch(*micro_batches(1)[0]))
        return seen

    plain = update()
    traced, events = profiled(update)
    assert len(ranges(events, "joeys2t.update")) == 1
    assert plain.keys() == traced.keys()
    for name, g in plain.items():
        assert torch.equal(g, traced[name]), name


def test_greedy_spans_a_step_each_with_its_readback(asr):
    stats = {}
    _, events = profiled(lambda: greedy(asr, stats))
    decode = ranges(events, "joeys2t.decode")
    steps = ranges(events, "joeys2t.decode.step")
    assert len(decode) == 1 and len(steps) == stats["decode_steps"] > 0
    assert inside(steps, decode) == [steps]
    assert [len(r) for r in inside(ranges(events, "joeys2t.decode.readback"), steps)] == \
        [1] * len(steps)
    assert [len(r) for r in inside(ranges(events, "joeys2t.decode.model"), steps)] == \
        [1] * len(steps)
    assert not ranges(events, "joeys2t.beam.select")


def test_beam_spans_scores_and_selection_a_step(asr):
    stats = {}
    _, events = profiled(lambda: beam(asr, stats))
    steps = ranges(events, "joeys2t.decode.step")
    assert len(steps) == stats["decode_steps"] > 0
    assert inside(steps, ranges(events, "joeys2t.decode")) == [steps]
    for name in ("joeys2t.beam.scores", "joeys2t.beam.select", "joeys2t.decode.model",
                 "joeys2t.decode.readback"):
        assert [len(r) for r in inside(ranges(events, name), steps)] == [1] * len(steps), name


@pytest.mark.parametrize("decode", [greedy, beam], ids=["greedy", "beam"])
def test_loop_clocks_add_up(asr, decode):
    stats = {}
    decode(asr, stats)
    decode(asr, stats)
    assert 0.0 < stats["readback_s"] <= stats["loop_s"]
    assert stats["decode_steps"] > 0


def test_update_holds_forward_backward_and_optimizer():
    tm = trainer()
    prepared = tm._prepare_batch(port_batch(*micro_batches(1)[0]))
    _, events = profiled(lambda: tm._train_prepared(prepared))
    update = ranges(events, "joeys2t.update")
    assert len(update) == 1
    for name in ("joeys2t.forward_backward", "joeys2t.optimizer"):
        assert inside(ranges(events, name), update) == [ranges(events, name)]
        assert len(ranges(events, name)) == 1, name


def test_transcriber_request_spans(asr):
    asr_ = Transcriber(asr["model"], asr["spec"], asr["vocab"], device="cpu")
    rng = np.random.RandomState(0)
    waves = [rng.randn(n).astype(np.float32) * 300 for n in (16000, 12000)]
    asr_.transcribe(waves, max_output_length=4)
    _, events = profiled(lambda: asr_.transcribe(waves, max_output_length=4))
    outer = ranges(events, "joeys2t.request")
    assert len(outer) == 1
    for name in ("joeys2t.frontend", "joeys2t.encode", "joeys2t.decode",
                 "joeys2t.detokenize"):
        assert [len(r) for r in inside(ranges(events, name), outer)] == [1], name
    assert asr_.stats["requests"] == 2
    assert 0.0 < asr_.stats["readback_s"] <= asr_.stats["loop_s"]


def test_search_request_holds_encode_and_decode(asr):
    from joeys2t_torch.data.batch import Batch

    src, lengths, _, _ = micro_batches(1, seed=4)[0]
    batch = Batch(src, lengths, None, None, None, None, np.arange(3), 1, 3,
                  is_train=False, task="S2T")
    stats = {}
    _, events = profiled(lambda: search(asr["model"], asr["spec"], batch, MAX_LEN, 1, 1.0,
                                        device="cpu", stats=stats))
    outer = ranges(events, "joeys2t.request")
    assert len(outer) == 1
    for name in ("joeys2t.encode", "joeys2t.decode"):
        assert [len(r) for r in inside(ranges(events, name), outer)] == [1], name
    assert len(ranges(events, "joeys2t.decode.step")) == stats["decode_steps"]
