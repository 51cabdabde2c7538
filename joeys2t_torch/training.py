# coding: utf-8
"""
The training update (counterpart of the core of joeys2t_tpu/training.py
``TrainManager`` :210 and ``TrainStatistics`` :1023).

One card: the model's float32 parameters are the master weights, the
forward runs in the model's compute dtype (bfloat16 on the card for the
flagship), and the gradients land in float32 on the masters. An optimizer
update is ``batch_multiplier`` micro-batches whose gradients accumulate in
the parameters' ``.grad`` (the JAX package's ``accum_step`` :557 and
``apply_accum`` :570; ``train_step`` :542 when the multiplier is 1), then
clipping, the optimizer and the scheduler's next rate. Dropout draws from
the trainer's generator, seeded with ``seed + 7919`` as the JAX trainer
seeds its dropout key (:307).

Not ported yet: validation, checkpoints, profiling, the data pipeline and
the epoch loop around :meth:`TrainManager.train_batch` (so schedulers that
step per epoch or per validation keep their initial rate), and the
multihost, tensor- and pipeline-parallel paths.
"""
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from joeys2t_torch.config import TrainConfig
from joeys2t_torch.data.batch import Batch
from joeys2t_torch.helpers import resolve_device
from joeys2t_torch.models.modules import set_dropout_generator
from joeys2t_torch.optim import (build_gradient_clipper, build_optimizer, build_scheduler,
                                 get_learning_rate, set_learning_rate)


class TrainManager:
    """Optimizer, clipper, scheduler and dropout generator around a model,
    and the training update on one device."""

    def __init__(self, model, spec, loss_fn, train_args: TrainConfig, seed: int = 42,
                 model_cfg: Optional[Dict] = None, device=None):
        self.device = resolve_device(device)
        sides = [(model_cfg or {}).get(side, {}) for side in ("encoder", "decoder")]
        if any(s.get("freeze") or s.get("embeddings", {}).get("freeze") for s in sides):
            raise NotImplementedError("`freeze` is not ported yet")
        self.model = model
        self.spec = spec
        self.loss_fn = loss_fn
        self.args = train_args
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
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 7919)
        set_dropout_generator(model, self.generator)
        enc_dtype = getattr(model.encoder, "dtype", torch.float32)
        fd = self.args.feature_dtype
        self._feature_dtype = (torch.bfloat16 if fd == "bfloat16" or (
            fd == "auto" and enc_dtype == torch.bfloat16) else torch.float32)
        self._micro = 0  # micro-batches accumulated towards the next update
        # the initial rate, before the first update (:667-668)
        if self.scheduler is not None and self.scheduler_step_at == "step":
            set_learning_rate(self.optimizer, self.scheduler.step(0))

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
            return None if x is None else torch.from_numpy(np.asarray(x)).to(dev, dtype)

        arrays = {
            "src": put(padded.src.astype(np.float32), self._feature_dtype),
            "src_length": put(padded.src_length, torch.long),
            "src_mask": put(padded.src_mask),
            "trg_input": put(padded.trg_input, torch.long),
            "trg": put(padded.trg, torch.long),
            "trg_length": put(padded.trg_length, torch.long),
            "trg_mask": put(padded.trg_mask),
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
        """The model in training mode on one prepared batch (:494)."""
        self.model.train()
        logits, ctc_logits, out_mask = self.model(
            batch["src"], batch["trg_input"], batch["src_length"], batch["src_mask"],
            batch["trg_mask"])
        return self._finish_loss(logits, ctc_logits, out_mask, batch, normalizer)

    def _finish_loss(self, logits, ctc_logits, out_mask, batch: Dict, normalizer: float):
        """Normalized loss and the metrics (loss, nll, ctc, n_correct), each
        divided by the normalizer and the accumulation count (:510)."""
        log_probs = torch.log_softmax(logits.float(), dim=-1)
        kwargs = dict(trg=batch["trg"])
        if self.loss_fn.require_ctc_layer and ctc_logits is not None:
            kwargs.update(trg_length=batch["trg_length"], src_mask=out_mask,
                          ctc_logits=ctc_logits)
        losses = self.loss_fn(log_probs, **kwargs)
        total = losses[0]
        nll = losses[1] if len(losses) > 1 else total
        ctc = losses[2] if len(losses) > 2 else torch.zeros((), device=total.device)
        trg_mask_2d = batch["trg_mask"][:, 0, :]
        n_correct = torch.sum(trg_mask_2d & (log_probs.argmax(-1) == batch["trg"]))
        div = normalizer * self.args.batch_multiplier
        norm = total / div
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
        """The per-batch body of the JAX ``train_and_validate`` (:722-770):
        one micro-batch, an update every ``batch_multiplier`` of them, the
        step count and, after each update, the scheduler's next rate. Returns
        the device metrics and whether an update ran."""
        nseqs, ntokens, arrays, normalizer = self._prepare_batch(batch)
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
