# coding: utf-8
"""
Training (counterpart of joeys2t_tpu/training.py: ``TrainManager`` :210
with ``train_and_validate`` :640, ``_validate`` :898 and the checkpoint
wiring :582-637, ``TrainStatistics`` :1023, ``train`` :1069).

One card per process: the model's float32 parameters are the master weights, the
forward runs in the model's compute dtype (bfloat16 on the card for the
flagship), and the gradients land in float32 on the masters. An optimizer
update is ``batch_multiplier`` micro-batches whose gradients accumulate in
the parameters' ``.grad`` (the JAX package's ``accum_step`` :557 and
``apply_accum`` :570; ``train_step`` :542 when the multiplier is 1), then
clipping, the optimizer and the scheduler's next rate. Dropout draws from
the trainer's generator, seeded with ``seed + 7919`` as the JAX trainer
seeds its dropout key (:307), plus the rank in a data-parallel run, so each
rank draws its own masks.

Data parallelism (``train -d``; the JAX package's ``data`` mesh axis and
multi-process path): each rank reads ``batch_size`` examples of its own
rank-strided shard, so an update covers world x ``batch_size`` x
``batch_multiplier`` examples. Before each micro-batch the ranks exchange
(has a batch, source and target lengths, sentences, tokens) on the host, as
JAX's ``_multihost_sync_stream`` (:126) does: the epoch ends at the first
rank that runs out, every rank pads to the longest source and target of the
step (the conv subsampler reads the padding frames beyond the longest
utterance, so the pad must be the one the union of the rows would have),
and the loss of each rank is divided by the count of the whole global batch,
as single-process JAX divides the loss of one global batch by its count
(:846-881). The training forward goes through ``DistributedDataParallel``,
whose all-reduce sums the ranks' gradients (a comm hook; DDP itself would
average them), with ``no_sync`` on all but the last micro-batch of an
update; checkpoints, validation and the closing test use the unwrapped
model, so parameter names carry no ``module.`` prefix. A mixture-of-experts
layer's routing statistics are summed over the ranks, so its load-balance
term is the global batch's. Only rank 0 writes checkpoints, reports,
hypotheses and logs; validation shares its batches out over the ranks
(``prediction.predict``), and every rank decides on the same merged scores.

The epoch loop reads, collates and uploads each batch on the loop's own
thread (the JAX package's prepare-prefetch thread is not ported: the host
pipeline's numpy and Python share one interpreter lock with the launch
loop, and on the card the thread did not shorten an update) and logs the
share of the loop's wall that went to the pipeline (with the ranks' host
exchange in a data-parallel run); device metrics are read at the logging
and validation boundaries only. Schedulers step where the JAX loop steps
them: per update, per epoch (:694-696) or per validation (:916-918).
Validation decodes greedily. ``load_encoder``/``load_decoder`` initialize
the encoder or decoder from another checkpoint (``init_layers`` :630).

``freeze: True`` on the encoder, the decoder or either side's embeddings
(JAX's ``frozen_prefixes`` :174 and ``_freeze_mask`` :187) holds the
parameters under that top-level name (``encoder``, ``decoder``,
``src_embed``, ``trg_embed``: the CTC head is the decoder's, a tied table
is ``trg_embed``'s) where they are. As in JAX, which masks their update to
zero after the clip and the optimizer (:280-287), they keep their
gradients, which count in the global-norm clip, and their optimizer state
moves; the trainer puts their values back after each update, so weight
decay does not move them either.

Rank 0 writes TensorBoard scalars (the training loss, accuracy and rate at
each logging step, the validation scores) and the validation's attention
plots to ``model_dir/tensorboard`` through tensorboardX's or
``torch.utils.tensorboard``'s ``SummaryWriter``, whichever imports, and
none when neither does (:263-270, :911, :1007-1015). A validation that
returns attention (a recurrent decoder's always, a transformer's with
``return_attention``) plots the ``print_valid_sents`` examples to
``att.<step>.<i>.png`` (:939-946). ``profile_dir`` (or the
``JOEYS2T_PROFILE_DIR`` environment variable, which overrides it) records a
``torch.profiler`` window from the update ``JOEYS2T_PROFILE_WINDOW`` names
first to the one it names last ("10,20" by default; :670-685, :760-767) and
writes it as a Chrome trace ``trace.<first>-<last>.json`` under the
directory, with the loop's spans (``joeys2t_torch.tracing``).

Tensor parallelism (``training: model_parallel``; JAX's (data, model) mesh,
:240-254, :340-364): the world splits into model groups of
``model_parallel`` consecutive ranks (``distributed.set_layout``) which
read the same batches, sharded by data rank. The trainer trains a sharded
copy of the model (``parallel/tp.py`` ``shard_model``): DDP sums its
gradients over the data group; under ``sequence_parallel`` the replicated
parameters of the layers, which each rank only sees its slice of the
sequence through, are summed over the model group too; the global-norm
clip sums the sharded gradients' squares over the model group and counts
the replicated ones once; Adam's moments live on the shards. The dropout
generator is seeded by data rank, so every rank of a model group draws the
same shapes in the same order and the replicated weights stay identical
on them. The model the caller passed stays whole and waits on the host,
so a rank keeps only its shards on the card: it takes the gathered weights
before each validation and checkpoint, which hold the whole model and the
whole optimizer state (as an unsharded run's, so ``test`` and resuming in
any layout read them), and is on the card only while validation decodes
it, sharded by data rank.

Pipeline parallelism (``pipeline_parallel``, ``pipeline_microbatches``;
JAX's ``_init_pipeline`` :366 and ``_loss_and_metrics_pp`` :434): the
encoder's layer stack, and the decoder's when its depth divides the
stages, run in GPipe stages over the pipe group (``parallel/pp.py``), the
rest of the model on every rank alike. The parameters stay whole and
replicated: each stage's layer gradients are summed over the pipe group,
all gradients over the data group, and every rank takes the same update,
so validation, ``test`` and checkpoints run as without it. The stages'
layers draw their dropout from a generator of the stage's own.
"""
import contextlib
import importlib
import math
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from joeys2t_torch import tracing
from joeys2t_torch.checkpoints import CheckpointManager, load_checkpoint, partial_load
from joeys2t_torch.config import (TestConfig, TrainConfig, check_ported, log_config,
                                  parse_global_args, set_validation_args)
from joeys2t_torch.data.batch import Batch
from joeys2t_torch.helpers import resolve_device, write_list_to_file
from joeys2t_torch.losses import loss_terms
from joeys2t_torch.config import ConfigurationError
from joeys2t_torch.models.decoders import TransformerDecoder
from joeys2t_torch.models.encoders import ConformerEncoder, TransformerEncoder
from joeys2t_torch.models.modules import MoEFeedForward, set_dropout_generator
from joeys2t_torch.optim import (GlobalNormClipper, build_gradient_clipper, build_optimizer,
                                 build_scheduler, get_learning_rate, set_learning_rate,
                                 state_split_dim)
from joeys2t_torch.parallel import distributed, tp
from joeys2t_torch.parallel.pp import PipePlan, pipeline_apply
from joeys2t_torch.plotting import store_attention_plots
from joeys2t_torch.prediction import predict, prepare, test
from joeys2t_torch.utils.logging import get_logger

logger = get_logger(__name__)


def frozen_prefixes(model_cfg: Dict) -> set:
    """The top-level parameter names that ``freeze: True`` in the model
    config holds (joeys2t_tpu/training.py:174-184)."""
    frozen = set()
    enc, dec = model_cfg.get("encoder", {}), model_cfg.get("decoder", {})
    if enc.get("freeze", False):
        frozen.add("encoder")
    if dec.get("freeze", False):
        frozen.add("decoder")
    if enc.get("embeddings", {}).get("freeze", False):
        frozen.add("src_embed")
    if dec.get("embeddings", {}).get("freeze", False):
        frozen.add("trg_embed")
    return frozen


def _tensorboard_writer(log_dir: Path):
    """A TensorBoard ``SummaryWriter`` into ``log_dir``: tensorboardX's, or
    ``torch.utils.tensorboard``'s, or None when neither imports (an
    optional dependency, as in JAX)."""
    for module in ("tensorboardX", "torch.utils.tensorboard"):
        try:
            return importlib.import_module(module).SummaryWriter(log_dir=str(log_dir))
        except Exception:  # pylint: disable=broad-except
            continue
    return None


class ProfileWindow:
    """A ``torch.profiler`` trace of the updates after update ``first`` up
    to update ``last`` (JAX's ``jax.profiler`` window), written as
    ``<directory>/trace.<first>-<last>.json``."""

    def __init__(self, directory, first: int, last: int, device: torch.device):
        self.directory, self.first, self.last = Path(directory), first, last
        self.device = device
        self.profiler = None

    @classmethod
    def from_config(cls, profile_dir, device) -> Optional["ProfileWindow"]:
        directory = os.environ.get("JOEYS2T_PROFILE_DIR") or profile_dir
        if not directory:
            return None
        first, last = (int(v) for v in
                       os.environ.get("JOEYS2T_PROFILE_WINDOW", "10,20").split(","))
        return cls(directory, first, last, device)

    def after_update(self, steps: int) -> None:
        """Start the trace after update ``first``, write it after ``last``."""
        from torch.profiler import ProfilerActivity, profile

        if steps == self.first and self.profiler is None:
            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self.profiler = profile(activities=activities)
            self.profiler.__enter__()
        elif steps == self.last and self.profiler is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.profiler.__exit__(None, None, None)
            self.directory.mkdir(parents=True, exist_ok=True)
            path = self.directory / f"trace.{self.first}-{self.last}.json"
            self.profiler.export_chrome_trace(str(path))
            logger.info("Profiler trace written to %s", path)
            self.profiler = None


def _sum_gradients(group, bucket):
    """DDP comm hook: the sum of the ranks' gradients (DDP's own hook
    averages them; the port divides each rank's loss by the global count)."""
    work = dist.all_reduce(bucket.buffer(), group=group, async_op=True)
    return work.get_future().then(lambda fut: fut.value()[0])


class TrainManager:
    """Optimizer, clipper, scheduler, dropout generator and checkpoints
    around a model; the training update and the epoch loop on this process's
    device, one rank of a data-parallel group when one is initialised."""

    # pylint: disable=too-many-instance-attributes

    def __init__(self, model, spec, loss_fn, train_args: TrainConfig, seed: int = 42,
                 model_cfg: Optional[Dict] = None, device=None,
                 model_dir: Optional[Path] = None, task: str = "S2T",
                 dev_args: Optional[TestConfig] = None, num_workers: int = 0):
        self.device = resolve_device(device)
        self.model = model
        self.spec = spec
        self.loss_fn = loss_fn
        self.args = train_args
        self.seed = seed
        self.task = task
        self.dev_cfg = dev_args
        self.num_workers = num_workers
        self.model_dir = None if model_dir is None else Path(model_dir)
        if any(p.dtype != torch.float32 or p.device.type != self.device.type
               for p in model.parameters() if p.requires_grad):
            raise ValueError(f"the model's parameters must be float32 masters on "
                             f"{self.device}")
        self.layout = distributed.set_layout(train_args.model_parallel,
                                             train_args.pipeline_parallel)
        self.tp = self.pp = None
        if self.layout is not None and self.layout.kind == "model":
            self.tp = tp.TPContext(self.layout.inner_group, self.layout.inner_rank,
                                   self.layout.inner,
                                   bool((model_cfg or {}).get("sequence_parallel", False)))
        # the module that trains: the model, or its shards under tensor
        # parallelism, when the whole model waits on the host (gathered into
        # before validation and checkpoints, on the card only to validate)
        if self.tp is None:
            self.net = model
        else:
            self.net = tp.shard_model(model.cpu(), self.tp).to(self.device)
        named = [(n, p) for n, p in self.net.named_parameters() if p.requires_grad]
        self.params = [p for _, p in named]
        self._names = [n for n, _ in named]
        self._split = [tp.split_dim(n) if self.tp is not None else None for n, _ in named]
        # under sequence parallelism each rank sees the layers' replicated
        # parameters through its slice of the sequence only
        self._partial = [self.tp is not None and self.tp.sequence_parallel
                         and dim is None and ".layers." in f".{n}"
                         for (n, _), dim in zip(named, self._split)]
        self.clipper = build_gradient_clipper(self.args.__dict__)
        shard_dims = {p: dim for p, dim in zip(self.params, self._split) if dim is not None}
        self.optimizer = build_optimizer(
            self.args.__dict__, self.params, shard_dims=shard_dims,
            shard_group=None if self.tp is None else self.tp.group,
            shard_world=1 if self.tp is None else self.tp.world)
        # the whole parameters' shapes, to gather a tensor-parallel state
        whole = dict(model.named_parameters())
        self._whole_shapes = [tuple(whole[n].shape) for n in self._names]
        frozen = frozen_prefixes(model_cfg or {})
        self._frozen = [p for n, p in named if n.split(".")[0] in frozen]
        if frozen:
            logger.info("Frozen parameter groups: %s", sorted(frozen))
        self.tb_writer = (_tensorboard_writer(self.model_dir / "tensorboard")
                          if self.model_dir is not None and distributed.is_main() else None)
        self.profile_window = ProfileWindow.from_config(train_args.profile_dir, self.device)
        self.scheduler, self.scheduler_step_at = build_scheduler(
            cfg=self.args.__dict__,
            scheduler_mode="min" if self.args.minimize_metric else "max",
            hidden_size=getattr(model.encoder, "hidden_size", 0))
        self.stats = TrainStatistics(minimize_metric=self.args.minimize_metric)
        self.ckpt_mgr = (None if self.model_dir is None else CheckpointManager(
            self.model_dir, keep_best_ckpts=self.args.keep_best_ckpts,
            minimize_metric=self.args.minimize_metric))
        self.batch_sampler = None
        self.train_iter_state = None
        self.world = distributed.data_world()  # the data-parallel ranks
        self.grouped = distributed.in_group()
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed + 7919 + distributed.data_rank())
        set_dropout_generator(self.net, self.generator)
        if self.layout is not None and self.layout.kind == "pipe":
            self._init_pipeline(seed)
        self._experts = [m for m in self.net.modules() if isinstance(m, MoEFeedForward)]
        for m in self._experts:
            m.global_stats = distributed.in_group()
            m.stats_group = None if self.layout is None else self.layout.data_group
        self._last_aux: Optional[torch.Tensor] = None  # the last micro-batch's term
        enc_dtype = getattr(model.encoder, "dtype", torch.float32)
        fd = self.args.feature_dtype
        self._feature_dtype = (torch.bfloat16 if fd == "bfloat16" or (
            fd == "auto" and enc_dtype == torch.bfloat16) else torch.float32)
        self._micro = 0  # micro-batches accumulated towards the next update
        # the initial rate, before the first update (:667-668); set here
        # once, so a resumed optimizer keeps the rate it was saved with
        if self.scheduler is not None and self.scheduler_step_at == "step":
            set_learning_rate(self.optimizer, self.scheduler.step(0))
        if self.args.load_model is not None:
            self.init_from_checkpoint(
                self.args.load_model, reset_best_ckpt=self.args.reset_best_ckpt,
                reset_scheduler=self.args.reset_scheduler,
                reset_optimizer=self.args.reset_optimizer,
                reset_iter_state=self.args.reset_iter_state)
        for layer_name, load_path in (("encoder", self.args.load_encoder),
                                      ("decoder", self.args.load_decoder)):
            if load_path is not None:
                self.init_layers(load_path, layer_name)
        self.ddp = self._wrap() if self.grouped and self.pp is None else None

    def _init_pipeline(self, seed: int) -> None:
        """Check and set up the GPipe path (JAX's ``_init_pipeline``): the
        encoder's stack always staged (a transformer or Conformer encoder
        without experts, its depth a multiple of the stages), the
        transformer decoder's when its depth divides them; the stages'
        layers get a dropout generator of their own."""
        enc, dec = self.model.encoder, self.model.decoder
        stages = self.layout.inner
        if not isinstance(enc, (TransformerEncoder, ConformerEncoder)):
            raise ConfigurationError("pipeline_parallel supports transformer and conformer "
                                     f"encoders (got {type(enc).__name__}).")
        if any(isinstance(m, MoEFeedForward) for m in enc.modules()):
            raise ConfigurationError("pipeline_parallel does not compose with MoE encoders.")
        if len(enc.layers) % stages:
            raise ConfigurationError(f"encoder num_layers={len(enc.layers)} must be divisible "
                                     f"by pipeline_parallel={stages}.")
        self.pp = PipePlan(self.layout.inner_group, self.layout.inner_ranks,
                           self.layout.inner_rank,
                           self.args.pipeline_microbatches or 2 * stages)
        self._pp_dec = isinstance(dec, TransformerDecoder) and len(dec.layers) % stages == 0
        if not self._pp_dec:
            logger.info("pipeline_parallel: decoder runs replicated (needs a transformer "
                        "decoder with num_layers divisible by %d).", stages)
        self._staged = [enc.layers[self.pp.stage_slice(len(enc.layers))]]
        if self._pp_dec:
            self._staged.append(dec.layers[self.pp.stage_slice(len(dec.layers))])
        stage_gen = torch.Generator(device=self.device).manual_seed(
            seed + 7919 + distributed.data_rank() + 7907 * (self.pp.stage + 1))
        for layers in self._staged:
            set_dropout_generator(layers, stage_gen)
        names = [f"{side}.layers." for side in ("encoder", "decoder")[:len(self._staged)]]
        self._in_stack = [any(n.startswith(prefix) for prefix in names)
                          for n, p in self.net.named_parameters() if p.requires_grad]
    def _params_without_gradient(self) -> List[str]:
        """The parameters the training loss never reaches, which DDP must
        leave out of its all-reduce: a speech model's CTC head under a loss
        without CTC, and the LSTM ``bias_hh`` halves that enter the cells
        detached (``models/rnn.py``)."""
        names = []
        if not self.loss_fn.require_ctc_layer:
            names += [n for n, _ in self.model.named_parameters()
                      if n.startswith("decoder.ctc_output_layer.")]
        for prefix, module in self.model.named_modules():
            if isinstance(module, nn.LSTM):
                names += [f"{prefix}.{n}" for n, _ in module.named_parameters()
                          if n.startswith("bias_hh")]
        return names

    def _wrap(self) -> DistributedDataParallel:
        """The training module under DDP over the data group (the world
        without tensor parallelism); the group's rank-0 parameters (its
        shards under tensor parallelism) are broadcast to its ranks here."""
        DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(
            self.net, self._params_without_gradient())
        group = dist.group.WORLD if self.layout is None else self.layout.data_group
        ddp = DistributedDataParallel(
            self.net, device_ids=([torch.cuda.current_device()]
                                  if self.device.type == "cuda" else None),
            process_group=group)
        ddp.register_comm_hook(group, _sum_gradients)
        return ddp

    @property
    def current_lr(self) -> float:
        return get_learning_rate(self.optimizer)

    # ------------------------------------------------------------- batches
    def _agree(self, batch: Optional[Batch]) -> Optional[Tuple[int, int, int, int]]:
        """The ranks' lockstep exchange before a micro-batch (JAX's
        ``_multihost_sync_stream`` :126): None when any rank has run out of
        batches (the epoch ends for all), else the step's longest source and
        target and its sentences and tokens over all ranks."""
        local = ([0] * 5 if batch is None else
                 [1, batch.src.shape[1], batch.trg.shape[1] if batch.has_trg else 0,
                  batch.nseqs, batch.ntokens])
        rows = distributed.data_rows(distributed.all_gather_counts(local))
        if min(r[0] for r in rows) == 0:
            if batch is not None:
                logger.warning("Data-parallel epoch sync: dropping local tail batch(es) so "
                               "all ranks finish the epoch together.")
            return None
        return (max(r[1] for r in rows), max(r[2] for r in rows), sum(r[3] for r in rows),
                sum(r[4] for r in rows))

    def _prepare_batch(self, batch: Batch, step: Optional[Tuple[int, int, int, int]] = None
                       ) -> Tuple[int, int, Dict, float]:
        """Pad and move a batch to the device, and compute its loss
        normalizer from the real counts (:846). Sentence batches are padded
        to ``batch_size`` rows, as the JAX package does; token batches keep
        their rows (``batch_size`` counts tokens there). Sequence lengths are
        not rounded up to buckets: PyTorch runs eagerly, so there are no
        compiled shapes to reuse, and the masks make the padding inert. In a
        data-parallel run ``step`` is :meth:`_agree`'s: the lengths to pad
        to, and the global counts that the normalizer and the returned
        counts are."""
        nseqs_real, ntokens_real = batch.nseqs, batch.ntokens
        target_b = nseqs_real
        if self.args.batch_type == "sentence":
            target_b = max(self.args.batch_size, nseqs_real)
        if step is None:
            padded = batch.pad_to_shape(batch_size=target_b, buckets=())
        else:
            src_len, trg_len, nseqs_real, ntokens_real = step
            padded = batch.pad_to_shape(batch_size=target_b, buckets=(), src_len=src_len,
                                        trg_len=trg_len or None)
        dev = self.device

        def put(x, dtype=None):
            if x is None:
                return None
            return torch.from_numpy(np.asarray(x)).to(dtype).to(dev)

        mt = padded.task == "MT"
        arrays = {
            # token ids as int64; features in the upload dtype
            "src": (put(padded.src, torch.long) if mt else
                    put(padded.src.astype(np.float32), self._feature_dtype)),
            "src_length": put(padded.src_length, torch.long),
            "src_mask": put(padded.src_mask),
            "trg_input": put(padded.trg_input, torch.long),
            "trg": put(padded.trg, torch.long),
            "trg_length": put(padded.trg_length, torch.long),
            "trg_mask": put(padded.trg_mask),
            "src_prompt_mask": put(padded.src_prompt_mask, torch.long),
            "trg_prompt_mask": put(padded.trg_prompt_mask, torch.long),
        }
        if self.args.normalization == "batch":
            normalizer = float(nseqs_real)
        elif self.args.normalization == "tokens":
            normalizer = float(ntokens_real)
        else:
            normalizer = 1.0
        return nseqs_real, ntokens_real, arrays, normalizer

    # ---------------------------------------------------------------- loss
    def _loss_and_metrics(self, batch: Dict, normalizer: float):
        """The model in training mode on one prepared batch (:494), with the
        load-balance terms its mixture-of-experts layers left."""
        self.net.train()
        if self.pp is not None:
            return self._loss_and_metrics_pp(batch, normalizer)
        logits, ctc_logits, out_mask = (self.ddp or self.net)(
            batch["src"], batch["trg_input"], batch["src_length"], batch["src_mask"],
            batch["trg_mask"], batch["src_prompt_mask"], batch["trg_prompt_mask"])
        aux = sum(m.aux_loss for m in self._experts) if self._experts else None
        return self._finish_loss(logits, ctc_logits, out_mask, batch, normalizer, aux)

    def _loss_and_metrics_pp(self, batch: Dict, normalizer: float):
        """The GPipe variant (JAX's ``_loss_and_metrics_pp``): the same
        math, the encoder's layer stack (and the decoder's, when staged) run
        by ``pipeline_apply`` over the pipe group."""
        model = self.net
        x, mask = model.encode_pre_layers(batch["src"], batch["src_length"],
                                          batch["src_mask"], batch["src_prompt_mask"])
        conformer = isinstance(model.encoder, ConformerEncoder)

        def encoder_stage(h, m):
            for layer in self._staged[0]:
                h = layer(h, m, None) if conformer else layer(h, m)
            return h

        enc_out = model.encode_post_layers(pipeline_apply(encoder_stage, x, self.pp, mask))
        if not self._pp_dec:
            logits, _, ctc_logits = model.decode(batch["trg_input"], enc_out, mask,
                                                 batch["trg_mask"], batch["trg_prompt_mask"])
        else:
            y, full_trg_mask = model.decode_pre_layers(batch["trg_input"], batch["trg_mask"],
                                                       batch["trg_prompt_mask"])

            def decoder_stage(h, memory, src_mask, trg_mask):
                for layer in self._staged[1]:
                    h = layer(h, memory, src_mask, trg_mask)
                return h

            y = pipeline_apply(decoder_stage, y, self.pp, enc_out, mask, full_trg_mask)
            logits, ctc_logits = model.decode_post_layers(y, enc_out)
        return self._finish_loss(logits, ctc_logits, mask, batch, normalizer)

    def _finish_loss(self, logits, ctc_logits, out_mask, batch: Dict, normalizer: float,
                     aux: Optional[torch.Tensor] = None):
        """Normalized loss and the metrics (loss, nll, ctc, n_correct), each
        divided by the normalizer and the accumulation count (:510). The
        Switch load-balance term ``aux`` adds 0.01 * aux, divided by the
        accumulation count only (:527-529), to the loss and the logged loss;
        validation computes no such term. In a data-parallel run the term is
        the global batch's on every rank, so each rank adds its share,
        1 / world of it, and the summed gradients count it once."""
        total, nll, ctc, n_correct, _ = loss_terms(
            self.loss_fn, logits, ctc_logits, out_mask, batch["trg"], batch["trg_length"],
            batch["trg_mask"])
        div = normalizer * self.args.batch_multiplier
        norm = total / div
        if aux is not None:
            norm = norm + 0.01 * aux / (self.args.batch_multiplier * self.world)
            self._last_aux = aux.detach()
        metrics = (norm.detach(), nll.detach() / div, ctc.detach() / div, n_correct)
        return norm, metrics

    # --------------------------------------------------------------- steps
    def train_step(self, batch: Dict, normalizer: float):
        """Forward, backward and one update (:542)."""
        self.optimizer.zero_grad(set_to_none=True)
        metrics = self.accum_step(batch, normalizer)
        self.apply_accum()
        return metrics

    def accum_step(self, batch: Dict, normalizer: float, sync: bool = True):
        """Forward and backward; the gradients add to ``.grad`` (:557). In a
        data-parallel run the ranks' gradients are summed in this backward
        unless ``sync`` is False (``no_sync``: a micro-batch before the last
        of an update)."""
        with tracing.span("joeys2t.forward_backward"), (
                self.ddp.no_sync() if self.ddp is not None and not sync
                else contextlib.nullcontext()):
            loss, metrics = self._loss_and_metrics(batch, normalizer)
            loss.backward()
        return metrics

    def apply_accum(self) -> None:
        """Clip the accumulated gradients, update, clear them (:570)."""
        with tracing.span("joeys2t.optimizer"):
            self.reduce_gradients()
            live = [i for i, p in enumerate(self.params) if p.grad is not None]
            grads = [self.params[i].grad for i in live]
            if isinstance(self.clipper, GlobalNormClipper) and self.tp is not None:
                self.clipper(grads, [self._split[i] is not None for i in live], self.tp.group)
            elif self.clipper is not None:
                self.clipper(grads)
            with torch.no_grad():
                kept = [p.clone() for p in self._frozen]
                self.optimizer.step()
                for p, value in zip(self._frozen, kept):
                    p.copy_(value)
            self.optimizer.zero_grad(set_to_none=True)

    def reduce_gradients(self) -> None:
        """Complete the accumulated gradients before clipping: sum them over
        the pipe and data groups under pipeline parallelism, and the layers'
        replicated ones over the model group under sequence parallelism
        (DDP has summed the rest over the data group in the backward)."""
        if self.pp is not None:
            self._sum_pipeline_grads()
        if any(self._partial):
            self._sum_grads([p.grad for p, part in zip(self.params, self._partial)
                             if part and p.grad is not None], self.tp.group)

    def full_gradients(self) -> Dict[str, torch.Tensor]:
        """The gradients as they stand, by parameter name, whole (the
        shards gathered over the model group: every rank of it calls this
        at once); zeros where a parameter has none."""
        out = {}
        for name, p, dim in zip(self._names, self.params, self._split):
            g = torch.zeros_like(p) if p.grad is None else p.grad
            out[name] = g if dim is None else tp.gather_along(g, dim, self.tp)
        return out

    @staticmethod
    def _sum_grads(grads: List[torch.Tensor], group) -> None:
        """Sum ``grads`` over ``group`` in place, in one flat buffer."""
        if not grads:
            return
        flat = torch._utils._flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=group)
        for g, synced in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
            g.copy_(synced)

    def _sum_pipeline_grads(self) -> None:
        """Each stage's layer gradients (zero on the other stages) summed
        over the world, the other gradients, the same on every stage, over
        the data group."""
        stack = []
        for p, staged in zip(self.params, self._in_stack):
            if staged:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                stack.append(p.grad)
        self._sum_grads(stack, dist.group.WORLD)
        if self.world > 1:
            self._sum_grads([p.grad for p, staged in zip(self.params, self._in_stack)
                             if not staged and p.grad is not None], self.layout.data_group)

    def train_batch(self, batch: Batch) -> Dict:
        """One micro-batch of the loop (:722-770) from a host batch; in a
        data-parallel run every rank calls it at the same step with its own
        batch."""
        step = None
        if self.grouped:
            step = self._agree(batch)
            if step is None:
                raise ValueError("a rank has no batch for this step")
        return self._train_prepared(self._prepare_batch(batch, step))

    def _train_prepared(self, prepared) -> Dict:
        """One micro-batch, an update every ``batch_multiplier`` of them, the
        step count and, after each update, the scheduler's next rate. Returns
        the device metrics and whether an update ran."""
        nseqs, ntokens, arrays, normalizer = prepared
        with tracing.span("joeys2t.update"):
            if self.args.batch_multiplier == 1:
                metrics = self.train_step(arrays, normalizer)
                stepped = True
            else:
                last = self._micro + 1 >= self.args.batch_multiplier
                metrics = self.accum_step(arrays, normalizer, sync=last)
                self._micro += 1
                stepped = last
                if stepped:
                    self.apply_accum()
                    self._micro = 0
            self.stats.total_tokens += ntokens
            if stepped:
                self.stats.steps += 1
                if self.scheduler is not None and self.scheduler_step_at == "step":
                    set_learning_rate(self.optimizer, self.scheduler.step(self.stats.steps))
                if self.stats.steps >= self.args.max_updates:
                    self.stats.is_max_update = True
        return {"loss": metrics[0], "nll": metrics[1], "ctc": metrics[2],
                "n_correct": metrics[3], "nseqs": nseqs, "ntokens": ntokens,
                "stepped": stepped}

    # ----------------------------------------------------------- checkpoints
    def _sync_model(self) -> None:
        """Under tensor parallelism, gather the shards into the whole model
        (a collective of the model group)."""
        if self.tp is not None:
            self.model.load_state_dict(tp.gather_state(self.net.state_dict(), self.tp))

    def _optimizer_state(self) -> Dict:
        """The optimizer's state; under tensor parallelism with the sharded
        moments gathered, as an unsharded run's."""
        state = self.optimizer.state_dict()
        if self.tp is None:
            return state
        full = {}
        for idx, st in state["state"].items():
            dims = self._state_dims(idx, st)
            full[idx] = {k: v if dims[k] is None else tp.gather_along(v, dims[k], self.tp)
                         for k, v in st.items()}
        return dict(state, state=full)

    def _state_dims(self, idx: int, st: Dict) -> Dict[str, Optional[int]]:
        """The dim along which each optimizer state entry of parameter
        ``idx`` is split over the model group, or None where every rank
        holds it whole."""
        dim = self._split[idx]
        return {k: None if dim is None else state_split_dim(
            self.optimizer, k, v, dim, self._whole_shapes[idx]) for k, v in st.items()}

    def _load_optimizer_state(self, state: Dict) -> None:
        if self.tp is not None:
            shards = {}
            for idx, st in state["state"].items():
                dims = self._state_dims(idx, st)
                shards[idx] = {k: v if dims[k] is None else
                               v.chunk(self.tp.world, dims[k])[self.tp.rank].clone()
                               for k, v in st.items()}
            state = dict(state, state=shards)
        self.optimizer.load_state_dict(state)

    def _load_net(self) -> None:
        """Under tensor parallelism, take this rank's shards of the model."""
        if self.tp is not None:
            self.net.load_state_dict(tp.shard_state(self.model.state_dict(), self.tp.rank,
                                                    self.tp.world))

    def _state_for_ckpt(self) -> Dict:
        self._sync_model()
        return {
            "model_state": self.model.state_dict(),
            "optimizer_state": self._optimizer_state(),
            "scheduler_state": (self.scheduler.state_dict()
                                if self.scheduler is not None else None),
            "train_iter_state": (self.batch_sampler.get_state()
                                 if self.batch_sampler is not None else None),
            "stats_state": self.stats.state_dict(),
        }

    def _save_checkpoint(self, new_best: bool, score: float) -> None:
        self.ckpt_mgr.save(self.stats.steps, self._state_for_ckpt(), new_best, score)

    def init_from_checkpoint(self, path, reset_best_ckpt: bool = False,
                             reset_scheduler: bool = False, reset_optimizer: bool = False,
                             reset_iter_state: bool = False) -> None:
        """Resume from a checkpoint (joeynmt/training.py:220-292): the model,
        and unless reset the optimizer (with its rate), the scheduler, the
        best-checkpoint tracking and the sampler's state."""
        logger.info("Loading model from %s", path)
        ckpt = load_checkpoint(path)
        self.model.load_state_dict(ckpt["model_state"], strict=True)
        self._load_net()
        if not reset_optimizer and ckpt.get("optimizer_state") is not None:
            self._load_optimizer_state(ckpt["optimizer_state"])
        elif reset_optimizer:
            logger.info("Reset optimizer.")
        if not reset_scheduler:
            if ckpt.get("scheduler_state") is not None and self.scheduler is not None:
                self.scheduler.load_state_dict(ckpt["scheduler_state"])
        else:
            logger.info("Reset scheduler.")
        if not reset_best_ckpt:
            if ckpt.get("stats_state") is not None:
                self.stats.load_state_dict(ckpt["stats_state"])
        else:
            logger.info("Reset tracking of the best checkpoint.")
        if not reset_iter_state:
            self.train_iter_state = ckpt.get("train_iter_state")
        else:
            logger.info("Reset data iterator (random seed: {%d}).", self.seed)

    def init_layers(self, path, layer: str) -> None:
        """Initialize the ``encoder`` or ``decoder`` from the model state of
        another checkpoint, for transfer such as ASR -> ST (:630-637)."""
        logger.info("Loading %s layers from %s", layer, path)
        state, _ = partial_load(self.model.state_dict(),
                                load_checkpoint(path)["model_state"], layer)
        self.model.load_state_dict(state, strict=True)
        self._load_net()

    # -------------------------------------------------------------- main loop
    def train_and_validate(self, train_data, valid_data) -> None:
        """Epochs of updates with logging, validation, checkpoints and the
        min-lr and max-update stops (joeynmt/training.py:311-539); ends with
        an unscored checkpoint, also after an interrupt; any other exception
        propagates without one."""
        # pylint: disable=too-many-branches,too-many-statements
        if self.ckpt_mgr is None:
            raise ValueError("the training loop needs a model_dir for its checkpoints")
        train_iter, self.batch_sampler = train_data.make_iter(
            batch_size=self.args.batch_size, batch_type=self.args.batch_type,
            seed=self.seed, shuffle=self.args.shuffle, num_workers=self.num_workers,
            eos_index=self.spec.eos_index, pad_index=self.spec.pad_index,
            return_sampler=True)
        if self.train_iter_state is not None:
            self.batch_sampler.set_state(self.train_iter_state)
        logger.info("Train config:\n\tdevice: %s\n\tdata-parallel ranks: %d\n"
                    "\tgradient accumulation: %d\n\tbatch size per rank: %d\n"
                    "\teffective batch size: %d", self.device, self.world,
                    self.args.batch_multiplier, self.args.batch_size,
                    self.world * self.args.batch_size * self.args.batch_multiplier)
        if self.layout is not None:
            logger.info("\t%s: %d ranks a group%s", "tensor-parallel" if self.tp else
                        "pipeline-parallel", self.layout.inner,
                        f", sequence parallel: {self.tp.sequence_parallel}" if self.tp else
                        f", {self.pp.n_micro} microbatches, decoder staged: {self._pp_dec}")

        epoch_no = self.stats.epochs
        loop_start, data_time, valid_time, updates_before = (time.perf_counter(), 0.0, 0.0,
                                                             self.stats.steps)
        try:
            for epoch_no in range(self.stats.epochs, self.args.epochs + 1):
                logger.info("EPOCH %d", epoch_no)
                self.stats.epochs = epoch_no
                if self.scheduler_step_at == "epoch":
                    set_learning_rate(self.optimizer, self.scheduler.step(epoch_no))
                train_data.seed = self.seed + epoch_no
                valid_data.seed = self.seed + epoch_no
                self.batch_sampler.set_seed(self.seed + epoch_no)

                start_tokens = self.stats.total_tokens
                start_correct = self.stats.total_correct
                epoch_nseqs, epoch_ntokens, epoch_loss = 0, 0, 0.0
                total_valid_duration = 0.0
                start = time.perf_counter()
                pending, micro_metrics = [], []  # device metrics awaiting a sync
                batches = iter(train_iter)
                while True:
                    t_data = time.perf_counter()  # read, collate, pad, upload
                    with tracing.span("joeys2t.data"):
                        batch = next(batches, None)
                        if self.grouped:  # lockstep: all ranks go on, or none
                            step = self._agree(batch)
                            batch = None if step is None else batch
                        else:
                            step = None
                        prepared = (None if batch is None
                                    else self._prepare_batch(batch, step))
                    data_time += time.perf_counter() - t_data
                    if prepared is None:
                        break
                    out = self._train_prepared(prepared)
                    micro_metrics.append((out["loss"], out["n_correct"]))
                    epoch_nseqs += out["nseqs"]
                    epoch_ntokens += out["ntokens"]
                    if out["stepped"]:
                        pending.append((self.stats.steps, micro_metrics))
                        micro_metrics = []
                        if self.profile_window is not None:
                            self.profile_window.after_update(self.stats.steps)
                        if self.stats.steps % self.args.logging_freq == 0:
                            losses_sum, last_loss = self._sync_pending_metrics(pending)
                            epoch_loss += losses_sum
                            elapsed = time.perf_counter() - start - total_valid_duration
                            self._log_scores(epoch_no, elapsed, start_tokens,
                                             start_correct, last_loss)
                            start = time.perf_counter()
                            start_tokens = self.stats.total_tokens
                            start_correct = self.stats.total_correct
                            total_valid_duration = 0.0
                        if self.stats.steps % self.args.validation_freq == 0:
                            epoch_loss += self._sync_pending_metrics(pending)[0]
                            valid_start_time = time.perf_counter()
                            valid_data.seed = self.seed + self.stats.steps
                            with tracing.span("joeys2t.validate"):
                                self._validate(valid_data)
                            total_valid_duration += time.perf_counter() - valid_start_time
                            valid_time += time.perf_counter() - valid_start_time
                    if self.stats.is_min_lr or self.stats.is_max_update:
                        break
                batches.close()  # stops a read-ahead worker (num_workers > 0) at a break

                if micro_metrics:
                    # an incomplete accumulation group at the epoch's end:
                    # no update ran, its losses still count
                    pending.append((self.stats.steps, micro_metrics))
                epoch_loss += self._sync_pending_metrics(pending)[0]
                if self.stats.is_min_lr or self.stats.is_max_update:
                    log_str = (f"minimum lr {self.args.learning_rate_min}"
                               if self.stats.is_min_lr else
                               f"maximum num. of updates {self.args.max_updates}")
                    logger.info("Training ended since %s was reached.", log_str)
                    break
                logger.info("Epoch %3d, total training loss: %.2f, num. of seqs: %d, "
                            "num. of tokens: %d, %.4f[sec]", epoch_no, epoch_loss,
                            epoch_nseqs, epoch_ntokens,
                            time.perf_counter() - start - total_valid_duration)
            else:
                logger.info("Training ended after %3d epochs.", epoch_no)
        except KeyboardInterrupt:
            logger.info("Interrupt at epoch %d, step %d.", epoch_no, self.stats.steps)
        else:
            logger.info("Best validation result (greedy) at step %8d: %6.2f %s.",
                        self.stats.best_ckpt_iter, self.stats.best_ckpt_score,
                        self.args.early_stopping_metric)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        loop_end = time.perf_counter()
        if self.tb_writer is not None:
            self.tb_writer.flush()
        self._save_checkpoint(False, float("nan"))
        train_wall = loop_end - loop_start - valid_time
        updates = self.stats.steps - updates_before
        logger.info("Training loop: %d update(s) in %.4f[sec] besides validation "
                    "(%.4f[sec] per update), %.4f[sec] (%.2f %%) of it in the data "
                    "pipeline (read, collate, upload); validation %.4f[sec]; final "
                    "checkpoint %.4f[sec].", updates, train_wall,
                    train_wall / max(updates, 1), data_time,
                    100.0 * data_time / max(train_wall, 1e-9), valid_time,
                    time.perf_counter() - loop_end)

    # ------------------------------------------------------------- validation
    def _validate(self, valid_data) -> None:
        """Validate greedily, step a per-validation scheduler, keep the
        checkpoint when it is among the best, report (:898). Every rank
        decodes its share and decides on the same merged scores; rank 0
        reports."""
        self._sync_model()
        try:
            (valid_scores, valid_references, valid_hypotheses, valid_hypotheses_raw, _,
             valid_attention_scores) = predict(
                self.model.to(self.device), self.spec, valid_data, loss_fn=self.loss_fn,
                compute_loss=True, normalization=self.args.normalization,
                args=self.dev_cfg, device=self.device)
        finally:
            if self.tp is not None:
                self.model.cpu()
        if self.tb_writer is not None:
            for eval_metric, score in valid_scores.items():
                if not math.isnan(score):
                    self.tb_writer.add_scalar(f"valid/{eval_metric}", score,
                                              self.stats.steps)
        ckpt_score = valid_scores[self.args.early_stopping_metric]
        if self.scheduler_step_at == "validation":
            set_learning_rate(self.optimizer, self.scheduler.step_metric(ckpt_score))
        new_best = self.stats.is_best(ckpt_score)
        if new_best:
            self.stats.best_ckpt_score = ckpt_score
            self.stats.best_ckpt_iter = self.stats.steps
            logger.info("Hooray! New best validation result [%s]!",
                        self.args.early_stopping_metric)
        is_better = (self.stats.is_better(ckpt_score, self.ckpt_mgr.ckpt_queue)
                     if self.ckpt_mgr.ckpt_queue else True)
        if self.args.keep_best_ckpts < 0 or is_better:
            self._save_checkpoint(new_best, ckpt_score)
        if distributed.is_main():
            self._add_report(valid_scores=valid_scores, new_best=new_best)
            self._log_examples(references=valid_references, hypotheses=valid_hypotheses,
                               data=valid_data)
            write_list_to_file(self.model_dir / f"{self.stats.steps}.hyps",
                               valid_hypotheses)
            if valid_attention_scores:
                store_attention_plots(
                    attentions=valid_attention_scores, targets=valid_hypotheses_raw,
                    sources=valid_data.get_list(lang=valid_data.src_lang, tokenized=True,
                                                subsampled=True),
                    indices=self.args.print_valid_sents,
                    output_prefix=(self.model_dir / f"att.{self.stats.steps}").as_posix(),
                    tb_writer=self.tb_writer, steps=self.stats.steps)

    def _add_report(self, valid_scores: Dict, new_best: bool = False) -> None:
        """One line of ``validations.txt`` (joeynmt/training.py:687-702)."""
        with (self.model_dir / "validations.txt").open("a", encoding="utf-8") as f:
            score_str = "\t".join(
                [f"Steps: {self.stats.steps}"]
                + [f"{metric}: {score:.5f}" for metric, score in valid_scores.items()
                   if not math.isnan(score)]
                + [f"LR: {self.current_lr:.8f}", "*" if new_best else ""])
            f.write(f"{score_str}\n")

    def _log_examples(self, hypotheses, references, data) -> None:
        """joeynmt/training.py:704-738."""
        for p in self.args.print_valid_sents:
            if p >= len(hypotheses):
                continue
            logger.info("Example #%d", p)
            src = (data.tokenizer[data.src_lang].post_process(data.src[p])
                   if self.task == "MT" else data.src[p])
            logger.info("\tSource:     %s", src)
            logger.info("\tReference:  %s", references[p])
            logger.info("\tHypothesis: %s", hypotheses[p])

    def _sync_pending_metrics(self, pending) -> Tuple[float, float]:
        """Read the deferred per-update device metrics in one sync (summed
        over the ranks in a data-parallel run): add the correct-token counts
        to the statistics, warn on a non-finite loss, and return (sum of the
        updates' losses, the last update's loss)."""
        step_losses = [sum(float(loss) for loss, _ in group) for _, group in pending]
        n_correct = sum(int(c) for _, group in pending for _, c in group)
        if self.grouped:
            *step_losses, n_correct = distributed.all_reduce_counts(step_losses + [n_correct])
        for (step_no, _), v in zip(pending, step_losses):
            if not np.isfinite(v):
                logger.warning("Non-finite batch loss %s at step %d", v, step_no)
        self.stats.total_correct += int(n_correct)
        pending.clear()
        return float(sum(step_losses)), (step_losses[-1] if step_losses else 0.0)

    def _log_scores(self, epoch_no, elapsed_time, start_tokens, start_correct,
                    total_batch_loss) -> None:
        """joeynmt/training.py:740-766; also flags the min-lr stop."""
        elapsed_tok = self.stats.total_tokens - start_tokens
        elapsed_correct = self.stats.total_correct - start_correct
        current_lr = self.current_lr
        if self.tb_writer is not None:
            steps = self.stats.steps
            self.tb_writer.add_scalar("train/batch_loss", total_batch_loss, steps)
            if elapsed_tok > 0:
                self.tb_writer.add_scalar("train/batch_acc", elapsed_correct / elapsed_tok,
                                          steps)
            self.tb_writer.add_scalar("train/learning_rate", current_lr, steps)
        if current_lr < self.args.learning_rate_min:
            self.stats.is_min_lr = True
        logger.info("Epoch %3d, Step: %8d, Batch Loss: %12.6f, Batch Acc: %.6f, "
                    "Tokens per Sec: %8.0f, Lr: %.6f", epoch_no, self.stats.steps,
                    total_batch_loss, elapsed_correct / max(elapsed_tok, 1),
                    elapsed_tok / max(elapsed_time, 1e-9), current_lr)
        if self._last_aux is not None:
            # included in the batch loss (x 0.01); 1 per layer at uniform routing
            logger.info("MoE load-balance term of the last micro-batch: %.6f "
                        "(%d layers)", float(self._last_aux), len(self._experts))


class TrainStatistics:
    """joeynmt/training.py:768-826."""

    def __init__(self, minimize_metric: bool = True) -> None:
        self.epochs = 1
        self.steps = 0
        self.is_min_lr = False
        self.is_max_update = False
        self.total_tokens = 0
        self.best_ckpt_iter = 0
        self.minimize_metric = minimize_metric
        self.best_ckpt_score = float("inf") if minimize_metric else float("-inf")
        self.total_correct = 0

    def is_best(self, score) -> bool:
        if self.minimize_metric:
            return score < self.best_ckpt_score
        return score > self.best_ckpt_score

    def is_better(self, score: float, heap_queue: list) -> bool:
        # heap entries are (key, path) with key = -score for minimized
        # metrics, so heap_queue[0] is the worst retained checkpoint
        if not heap_queue:
            raise ValueError("empty checkpoint queue")
        key = -score if self.minimize_metric else score
        return key > heap_queue[0][0]

    def state_dict(self) -> Dict:
        return {
            "epochs": self.epochs,
            "steps": self.steps,
            "total_tokens": self.total_tokens,
            "total_correct": self.total_correct,
            "best_ckpt_score": self.best_ckpt_score,
            "best_ckpt_iter": self.best_ckpt_iter,
        }

    def load_state_dict(self, state_dict: Dict) -> None:
        self.epochs = state_dict["epochs"]
        self.steps = state_dict["steps"]
        self.total_tokens = state_dict["total_tokens"]
        self.total_correct = state_dict["total_correct"]
        self.best_ckpt_score = state_dict["best_ckpt_score"]
        self.best_ckpt_iter = state_dict["best_ckpt_iter"]


def train(cfg: Dict, skip_test: bool = False) -> None:
    """Train from a config, then test the best (or latest) checkpoint on the
    dev and test sets (joeynmt/training.py:829-895). In a data-parallel run
    every rank calls it; the ranks wait for one another before the test
    reads the checkpoint rank 0 wrote (JAX :1087-1093)."""
    log_config(cfg)
    args = parse_global_args(cfg, rank=distributed.rank(), mode="train")
    check_ported(args)
    model, spec, loss_fn, train_data, dev_data, test_data = prepare(
        args, rank=distributed.rank(), mode="train")
    trainer = TrainManager(model, spec, loss_fn, args.train, seed=args.seed,
                           model_cfg=args.model, device=args.device,
                           model_dir=args.model_dir, task=args.task,
                           dev_args=set_validation_args(args.test),
                           num_workers=args.num_workers)
    trainer.train_and_validate(train_data=train_data, valid_data=dev_data)
    distributed.barrier()
    if skip_test:
        logger.info("Skipping test after training.")
        return
    ckpt = args.model_dir / "best.ckpt"
    if not ckpt.exists():
        ckpt = args.model_dir / "latest.ckpt"
    model.load_state_dict(load_checkpoint(ckpt)["model_state"], strict=True)
    model.to(trainer.device)  # tensor parallelism kept it on the host
    test(cfg=cfg, output_path=(args.model_dir / f"{ckpt.stem}.hyps").as_posix(),
         prepared={"model": model, "spec": spec, "loss_fn": loss_fn, "dev": dev_data,
                   "test": test_data})
