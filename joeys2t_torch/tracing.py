# coding: utf-8
"""
Named spans at the port's layer boundaries, on the profiler's clock.

``span(name, args)`` opens ``torch.profiler.record_function(name, args)``
while a ``torch.profiler`` profile records, so the range lands in the
profiler's host timeline beside the device operations it launched: in a
trace taken around any call of the port, and in the Chrome trace that
``profile_dir`` writes. With no profile recording it returns one shared
no-op context: nothing is allocated or recorded and no device work is added.
The profiler is the only switch.

The spans (names fixed; the transformer decode loops only):

- ``joeys2t.request``: a ``Transcriber.transcribe_batch`` call (its request
  number as ``args``) or a ``search.search`` call;
- ``joeys2t.frontend``: the transcriber's on-device filterbank and CMVN;
- ``joeys2t.encode``: ``model.encode``;
- ``joeys2t.decode``: a greedy or beam loop and its copy-out to numpy;
- ``joeys2t.decode.step``: one iteration, with ``joeys2t.decode.model``
  (``model.decode_step``) and ``joeys2t.decode.readback`` (the blocking read
  of the stop flag) inside it, and in beam search ``joeys2t.beam.scores``
  (log-softmax, history controls, bans, forced prefix, the beams' scores,
  length penalty) and ``joeys2t.beam.select`` (the stable top-k over K x V
  candidates, token and parent ids);
- ``joeys2t.detokenize``: the transcriber's ids to text;
- ``joeys2t.update``: ``TrainManager._train_prepared``, one micro-batch and
  its update, with ``joeys2t.forward_backward`` (loss and backward) and
  ``joeys2t.optimizer`` (gradient reduction, clipping, the optimizer step,
  ``zero_grad``);
- ``joeys2t.data`` and ``joeys2t.validate``: the training loop's data
  pipeline (read, collate, pad, upload) and its validations.
"""
import contextlib
from typing import Optional

from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str, args: Optional[str] = None):
    """A ``record_function`` range named ``name`` while a profiler records,
    else the shared no-op context."""
    if not _profiler._is_profiler_enabled:  # pylint: disable=protected-access
        return _OFF
    return _profiler.record_function(name, args)
