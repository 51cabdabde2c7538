# coding: utf-8
"""
Training (counterpart of joeys2t_tpu/training.py: ``TrainManager`` :210
with ``train_and_validate`` :640, ``_validate`` :898 and the checkpoint
wiring :582-637, ``TrainStatistics`` :1023, ``train`` :1069).

One card: the model's float32 parameters are the master weights, the
forward runs in the model's compute dtype (bfloat16 on the card for the
flagship), and the gradients land in float32 on the masters. An optimizer
update is ``batch_multiplier`` micro-batches whose gradients accumulate in
the parameters' ``.grad`` (the JAX package's ``accum_step`` :557 and
``apply_accum`` :570; ``train_step`` :542 when the multiplier is 1), then
clipping, the optimizer and the scheduler's next rate. Dropout draws from
the trainer's generator, seeded with ``seed + 7919`` as the JAX trainer
seeds its dropout key (:307).

The epoch loop reads, collates and uploads each batch on the loop's own
thread (the JAX package's prepare-prefetch thread is not ported: the host
pipeline's numpy and Python share one interpreter lock with the launch
loop, and on the card the thread did not shorten an update) and logs the
share of the loop's wall that went to the pipeline; device metrics are read
at the logging and validation boundaries only. Schedulers step where the JAX
loop steps them: per update, per epoch (:694-696) or per validation
(:916-918). Validation decodes greedily. ``load_encoder``/``load_decoder``
initialize the encoder or decoder from another checkpoint
(``init_layers`` :630). Not ported yet: profiling, a TensorBoard writer,
attention plots, ``freeze``, and the multihost, tensor- and
pipeline-parallel paths.
"""
import math
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from joeys2t_torch.checkpoints import CheckpointManager, load_checkpoint, partial_load
from joeys2t_torch.config import (TestConfig, TrainConfig, check_ported, log_config,
                                  parse_global_args, set_validation_args)
from joeys2t_torch.data.batch import Batch
from joeys2t_torch.helpers import resolve_device, write_list_to_file
from joeys2t_torch.losses import loss_terms
from joeys2t_torch.models.modules import MoEFeedForward, set_dropout_generator
from joeys2t_torch.optim import (build_gradient_clipper, build_optimizer, build_scheduler,
                                 get_learning_rate, set_learning_rate)
from joeys2t_torch.prediction import predict, prepare, test
from joeys2t_torch.utils.logging import get_logger

logger = get_logger(__name__)


class TrainManager:
    """Optimizer, clipper, scheduler, dropout generator and checkpoints
    around a model; the training update and the epoch loop on one device."""

    # pylint: disable=too-many-instance-attributes

    def __init__(self, model, spec, loss_fn, train_args: TrainConfig, seed: int = 42,
                 model_cfg: Optional[Dict] = None, device=None,
                 model_dir: Optional[Path] = None, task: str = "S2T",
                 dev_args: Optional[TestConfig] = None, num_workers: int = 0):
        self.device = resolve_device(device)
        sides = [(model_cfg or {}).get(side, {}) for side in ("encoder", "decoder")]
        if any(s.get("freeze") or s.get("embeddings", {}).get("freeze") for s in sides):
            raise NotImplementedError("`freeze` is not ported yet")
        self.model = model
        self.spec = spec
        self.loss_fn = loss_fn
        self.args = train_args
        self.seed = seed
        self.task = task
        self.dev_cfg = dev_args
        self.num_workers = num_workers
        self.model_dir = None if model_dir is None else Path(model_dir)
        self.params = [p for p in model.parameters() if p.requires_grad]
        if any(p.dtype != torch.float32 or p.device.type != self.device.type
               for p in self.params):
            raise ValueError(f"the model's parameters must be float32 masters on "
                             f"{self.device}")
        self.clipper = build_gradient_clipper(self.args.__dict__)
        self.optimizer = build_optimizer(self.args.__dict__, self.params)
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
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 7919)
        set_dropout_generator(model, self.generator)
        self._experts = [m for m in model.modules() if isinstance(m, MoEFeedForward)]
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

    @property
    def current_lr(self) -> float:
        return get_learning_rate(self.optimizer)

    # ------------------------------------------------------------- batches
    def _prepare_batch(self, batch: Batch) -> Tuple[int, int, Dict, float]:
        """Pad and move a batch to the device, and compute its loss
        normalizer from the real counts (:846). Sentence batches are padded
        to ``batch_size`` rows, as the JAX package does; token batches keep
        their rows (``batch_size`` counts tokens there). Sequence lengths are
        not rounded up to buckets: PyTorch runs eagerly, so there are no
        compiled shapes to reuse, and the masks make the padding inert."""
        nseqs_real, ntokens_real = batch.nseqs, batch.ntokens
        target_b = nseqs_real
        if self.args.batch_type == "sentence":
            target_b = max(self.args.batch_size, nseqs_real)
        padded = batch.pad_to_shape(batch_size=target_b, buckets=())
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
        self.model.train()
        logits, ctc_logits, out_mask = self.model(
            batch["src"], batch["trg_input"], batch["src_length"], batch["src_mask"],
            batch["trg_mask"], batch["src_prompt_mask"], batch["trg_prompt_mask"])
        aux = sum(m.aux_loss for m in self._experts) if self._experts else None
        return self._finish_loss(logits, ctc_logits, out_mask, batch, normalizer, aux)

    def _finish_loss(self, logits, ctc_logits, out_mask, batch: Dict, normalizer: float,
                     aux: Optional[torch.Tensor] = None):
        """Normalized loss and the metrics (loss, nll, ctc, n_correct), each
        divided by the normalizer and the accumulation count (:510). The
        Switch load-balance term ``aux`` adds 0.01 * aux, divided by the
        accumulation count only (:527-529), to the loss and the logged loss;
        validation computes no such term."""
        total, nll, ctc, n_correct, _ = loss_terms(
            self.loss_fn, logits, ctc_logits, out_mask, batch["trg"], batch["trg_length"],
            batch["trg_mask"])
        div = normalizer * self.args.batch_multiplier
        norm = total / div
        if aux is not None:
            norm = norm + 0.01 * aux / self.args.batch_multiplier
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

    def accum_step(self, batch: Dict, normalizer: float):
        """Forward and backward; the gradients add to ``.grad`` (:557)."""
        loss, metrics = self._loss_and_metrics(batch, normalizer)
        loss.backward()
        return metrics

    def apply_accum(self) -> None:
        """Clip the accumulated gradients, update, clear them (:570)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.clipper is not None:
            self.clipper(grads)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    def train_batch(self, batch: Batch) -> Dict:
        """One micro-batch of the loop (:722-770) from a host batch."""
        return self._train_prepared(self._prepare_batch(batch))

    def _train_prepared(self, prepared) -> Dict:
        """One micro-batch, an update every ``batch_multiplier`` of them, the
        step count and, after each update, the scheduler's next rate. Returns
        the device metrics and whether an update ran."""
        nseqs, ntokens, arrays, normalizer = prepared
        if self.args.batch_multiplier == 1:
            metrics = self.train_step(arrays, normalizer)
            stepped = True
        else:
            metrics = self.accum_step(arrays, normalizer)
            self._micro += 1
            stepped = self._micro >= self.args.batch_multiplier
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
    def _state_for_ckpt(self) -> Dict:
        return {
            "model_state": self.model.state_dict(),
            "optimizer_state": self.optimizer.state_dict(),
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
        if not reset_optimizer and ckpt.get("optimizer_state") is not None:
            self.optimizer.load_state_dict(ckpt["optimizer_state"])
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
        logger.info("Train config:\n\tdevice: %s\n\tgradient accumulation: %d\n"
                    "\tbatch size: %d\n\teffective batch size: %d", self.device,
                    self.args.batch_multiplier, self.args.batch_size,
                    self.args.batch_size * self.args.batch_multiplier)

        epoch_no = self.stats.epochs
        loop_start, data_time, valid_time, updates_before = (time.time(), 0.0, 0.0,
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
                start = time.time()
                pending, micro_metrics = [], []  # device metrics awaiting a sync
                batches = iter(train_iter)
                while True:
                    t_data = time.perf_counter()  # read, collate, pad, upload
                    batch = next(batches, None)
                    prepared = None if batch is None else self._prepare_batch(batch)
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
                        if self.stats.steps % self.args.logging_freq == 0:
                            losses_sum, last_loss = self._sync_pending_metrics(pending)
                            epoch_loss += losses_sum
                            elapsed = time.time() - start - total_valid_duration
                            self._log_scores(epoch_no, elapsed, start_tokens,
                                             start_correct, last_loss)
                            start = time.time()
                            start_tokens = self.stats.total_tokens
                            start_correct = self.stats.total_correct
                            total_valid_duration = 0.0
                        if self.stats.steps % self.args.validation_freq == 0:
                            epoch_loss += self._sync_pending_metrics(pending)[0]
                            valid_start_time = time.time()
                            valid_data.seed = self.seed + self.stats.steps
                            self._validate(valid_data)
                            total_valid_duration += time.time() - valid_start_time
                            valid_time += time.time() - valid_start_time
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
                            time.time() - start - total_valid_duration)
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
        loop_end = time.time()
        self._save_checkpoint(False, float("nan"))
        train_wall = loop_end - loop_start - valid_time
        updates = self.stats.steps - updates_before
        logger.info("Training loop: %d update(s) in %.4f[sec] besides validation "
                    "(%.4f[sec] per update), %.4f[sec] (%.2f %%) of it in the data "
                    "pipeline (read, collate, upload); validation %.4f[sec]; final "
                    "checkpoint %.4f[sec].", updates, train_wall,
                    train_wall / max(updates, 1), data_time,
                    100.0 * data_time / max(train_wall, 1e-9), valid_time,
                    time.time() - loop_end)

    # ------------------------------------------------------------- validation
    def _validate(self, valid_data) -> None:
        """Validate greedily, step a per-validation scheduler, keep the
        checkpoint when it is among the best, report (:898)."""
        valid_scores, valid_references, valid_hypotheses, _, _, _ = predict(
            self.model, self.spec, valid_data, loss_fn=self.loss_fn, compute_loss=True,
            normalization=self.args.normalization, args=self.dev_cfg, device=self.device)
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
        self._add_report(valid_scores=valid_scores, new_best=new_best)
        self._log_examples(references=valid_references, hypotheses=valid_hypotheses,
                           data=valid_data)
        write_list_to_file(self.model_dir / f"{self.stats.steps}.hyps", valid_hypotheses)

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
        """Read the deferred per-update device metrics in one sync: add the
        correct-token counts to the statistics, warn on a non-finite loss, and
        return (sum of the updates' losses, the last update's loss)."""
        losses_sum, last_loss = 0.0, 0.0
        for step_no, group in pending:
            step_loss = 0.0
            for loss, n_correct in group:
                v = float(loss)
                if not np.isfinite(v):
                    logger.warning("Non-finite batch loss %s at step %d", v, step_no)
                step_loss += v
                self.stats.total_correct += int(n_correct)
            losses_sum += step_loss
            last_loss = step_loss
        pending.clear()
        return losses_sum, last_loss

    def _log_scores(self, epoch_no, elapsed_time, start_tokens, start_correct,
                    total_batch_loss) -> None:
        """joeynmt/training.py:740-766; also flags the min-lr stop."""
        elapsed_tok = self.stats.total_tokens - start_tokens
        elapsed_correct = self.stats.total_correct - start_correct
        current_lr = self.current_lr
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
    dev and test sets (joeynmt/training.py:829-895)."""
    log_config(cfg)
    args = parse_global_args(cfg, rank=0, mode="train")
    check_ported(args)
    model, spec, loss_fn, train_data, dev_data, test_data = prepare(args, rank=0,
                                                                    mode="train")
    trainer = TrainManager(model, spec, loss_fn, args.train, seed=args.seed,
                           model_cfg=args.model, device=args.device,
                           model_dir=args.model_dir, task=args.task,
                           dev_args=set_validation_args(args.test),
                           num_workers=args.num_workers)
    trainer.train_and_validate(train_data=train_data, valid_data=dev_data)
    if skip_test:
        logger.info("Skipping test after training.")
        return
    ckpt = args.model_dir / "best.ckpt"
    if not ckpt.exists():
        ckpt = args.model_dir / "latest.ckpt"
    model.load_state_dict(load_checkpoint(ckpt)["model_state"], strict=True)
    test(cfg=cfg, output_path=(args.model_dir / f"{ckpt.stem}.hyps").as_posix(),
         prepared={"model": model, "spec": spec, "loss_fn": loss_fn, "dev": dev_data,
                   "test": test_data})
