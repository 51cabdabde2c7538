# coding: utf-8
"""
Gradient clipping, optimizers and learning-rate schedulers (counterpart of
joeys2t_tpu/optim.py).

Clipping follows optax: global-norm clipping scales the gradients by
``max_norm / ||g||`` when ``||g|| >= max_norm`` (not ``clip_grad_norm_``'s
``max_norm / (||g|| + 1e-6)``), computed on the device without a host sync.
Adam and AdamW are ``torch.optim``'s, which do optax's update: eps 1e-8
outside the square root (eps_root 0), and AdamW's decoupled decay applied
as ``-lr * (adam + wd * theta)``; the trainer writes the scheduler's rate
into the optimizer before each update. The other optimizers of the JAX
package are not ported yet. The schedulers are plain Python, as in the JAX
package (joeynmt/builders.py:253-485), with their ``state_dict``.
"""
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from joeys2t_torch.config import PORTED_OPTIMIZERS, ConfigurationError


class GlobalNormClipper:
    """optax.clip_by_global_norm: g <- (g / ||g||) * max_norm unless
    ||g|| < max_norm, with ||g|| over all gradients together."""

    def __init__(self, max_norm: float):
        self.max_norm = float(max_norm)

    def __call__(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """Clip ``grads`` in place; returns the global norm before clipping
        (a device scalar)."""
        norm = torch.stack(torch._foreach_norm(grads)).square().sum().sqrt()
        keep = norm < self.max_norm
        one = torch.ones((), device=norm.device)
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one, one * self.max_norm))
        return norm


class ValueClipper:
    """optax.clip: each gradient value clamped to [-delta, delta]."""

    def __init__(self, delta: float):
        self.delta = float(delta)

    def __call__(self, grads: List[torch.Tensor]) -> None:
        torch._foreach_clamp_min_(grads, -self.delta)
        torch._foreach_clamp_max_(grads, self.delta)


def build_gradient_clipper(cfg: Dict):
    """Gradient clipping by value or global norm (joeys2t_tpu/optim.py:21);
    None without either."""
    if cfg.get("clip_grad_val") is not None and cfg.get("clip_grad_norm") is not None:
        raise ConfigurationError(
            "You can only specify either clip_grad_val or clip_grad_norm.")
    if cfg.get("clip_grad_val") is not None:
        return ValueClipper(cfg["clip_grad_val"])
    if cfg.get("clip_grad_norm") is not None:
        return GlobalNormClipper(cfg["clip_grad_norm"])
    return None


def build_optimizer(cfg: Dict, params: Iterable[torch.nn.Parameter]
                    ) -> torch.optim.Optimizer:
    """Adam or AdamW over ``params`` from the training config
    (joeys2t_tpu/optim.py:51)."""
    name = cfg.get("optimizer", "sgd").lower()
    if name not in PORTED_OPTIMIZERS:
        raise NotImplementedError(f"optimizer {name!r} is not ported yet")
    if cfg.get("moment_dtype") is not None:
        raise NotImplementedError("moment_dtype is not ported yet")
    lr = cfg.get("learning_rate", 3.0e-4)
    weight_decay = cfg.get("weight_decay", 0)
    betas = tuple(cfg.get("adam_betas", (0.9, 0.999)))
    # torch Adam adds the L2 term to the raw gradients, as optax's
    # add_decayed_weights placed before scale_by_adam does
    cls = torch.optim.Adam if name == "adam" else torch.optim.AdamW
    return cls(params, lr=lr, betas=betas, eps=1e-8, weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, rate: float) -> None:
    """Write the scheduler's rate into every parameter group."""
    for group in optimizer.param_groups:
        group["lr"] = rate


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


# ------------------------------------------------------------------ schedulers
class BaseScheduler:
    """Host-side scheduler with state_dict parity
    (joeynmt/builders.py:253-287)."""

    def __init__(self):
        self._step = 0
        self._rate = 0.0

    def state_dict(self) -> Dict:
        return {"step": self._step, "rate": self._rate}

    def load_state_dict(self, state_dict: Dict) -> None:
        self._step = state_dict["step"]
        self._rate = state_dict["rate"]

    def step(self, step: int) -> float:
        """Sync with trainer step count; returns the new rate."""
        self._step = step + 1
        self._rate = self._compute_rate()
        return self._rate

    @property
    def rate(self) -> float:
        return self._rate

    def _compute_rate(self) -> float:
        raise NotImplementedError


class NoamScheduler(BaseScheduler):
    """Noam schedule (joeynmt/builders.py:290-341)."""

    def __init__(self, hidden_size: int, factor: float = 1.0, warmup: int = 4000):
        super().__init__()
        self.warmup = warmup
        self.factor = factor
        self.hidden_size = hidden_size

    def _compute_rate(self):
        step = self._step
        upper_bound = min(step**(-0.5), step * self.warmup**(-1.5))
        return self.factor * (self.hidden_size**(-0.5) * upper_bound)

    def state_dict(self):
        d = super().state_dict()
        d.update(warmup=self.warmup, factor=self.factor, hidden_size=self.hidden_size)
        return d

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        self.warmup = state_dict["warmup"]
        self.factor = state_dict["factor"]
        self.hidden_size = state_dict["hidden_size"]

    def __repr__(self):
        return (f"{self.__class__.__name__}(warmup={self.warmup}, "
                f"factor={self.factor}, hidden_size={self.hidden_size})")


class WarmupExponentialDecayScheduler(BaseScheduler):
    """joeynmt/builders.py:344-415."""

    def __init__(self, peak_rate: float = 1.0e-3, decay_length: int = 10000,
                 warmup: int = 4000, decay_rate: float = 0.5,
                 min_rate: float = 1.0e-5):
        super().__init__()
        self.warmup = warmup
        self.decay_length = decay_length
        self.peak_rate = peak_rate
        self.decay_rate = decay_rate
        self.min_rate = min_rate

    def _compute_rate(self):
        step = self._step
        if step < self.warmup:
            rate = step * self.peak_rate / self.warmup
        else:
            exponent = (step - self.warmup) / self.decay_length
            rate = self.peak_rate * (self.decay_rate**exponent)
        return max(rate, self.min_rate)

    def state_dict(self):
        d = super().state_dict()
        d.update(warmup=self.warmup, decay_length=self.decay_length,
                 peak_rate=self.peak_rate, decay_rate=self.decay_rate,
                 min_rate=self.min_rate)
        return d

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        self.warmup = state_dict["warmup"]
        self.decay_length = state_dict["decay_length"]
        self.peak_rate = state_dict["peak_rate"]
        self.decay_rate = state_dict["decay_rate"]
        self.min_rate = state_dict["min_rate"]

    def __repr__(self):
        return (f"{self.__class__.__name__}(warmup={self.warmup}, "
                f"decay_length={self.decay_length}, decay_rate={self.decay_rate}, "
                f"peak_rate={self.peak_rate}, min_rate={self.min_rate})")


class WarmupInverseSquareRootScheduler(BaseScheduler):
    """joeynmt/builders.py:418-485."""

    def __init__(self, peak_rate: float = 1.0e-3, warmup: int = 10000,
                 min_rate: float = 1.0e-5):
        super().__init__()
        self.warmup = warmup
        self.min_rate = min_rate
        self.peak_rate = peak_rate
        self.decay_rate = peak_rate * (warmup**0.5)

    def _compute_rate(self):
        step = self._step
        if step < self.warmup:
            rate = step * self.peak_rate / self.warmup
        else:
            rate = self.decay_rate * (step**-0.5)
        return max(rate, self.min_rate)

    def state_dict(self):
        d = super().state_dict()
        d.update(warmup=self.warmup, peak_rate=self.peak_rate,
                 decay_rate=self.decay_rate, min_rate=self.min_rate)
        return d

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        self.warmup = state_dict["warmup"]
        self.decay_rate = state_dict["decay_rate"]
        self.peak_rate = state_dict["peak_rate"]
        self.min_rate = state_dict["min_rate"]

    def __repr__(self):
        return (f"{self.__class__.__name__}(warmup={self.warmup}, "
                f"decay_rate={self.decay_rate:.6f}, peak_rate={self.peak_rate}, "
                f"min_rate={self.min_rate})")


class PlateauScheduler(BaseScheduler):
    """ReduceLROnPlateau equivalent (torch semantics with threshold_mode=abs,
    eps=0; joeynmt/builders.py:175-187): multiply the rate by `factor` after
    `patience` validations without improvement."""

    def __init__(self, initial_rate: float, mode: str = "min", factor: float = 0.1,
                 patience: int = 10):
        super().__init__()
        self._rate = initial_rate
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.best = float("inf") if mode == "min" else float("-inf")
        self.num_bad = 0

    def step(self, step: int) -> float:  # noqa: ARG002 - signature parity
        return self._rate

    def step_metric(self, metric: float) -> float:
        """Called after each validation with the monitored score."""
        improved = (metric < self.best) if self.mode == "min" else (metric > self.best)
        if improved:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self._rate = self._rate * self.factor
                self.num_bad = 0
        return self._rate

    def _compute_rate(self):
        return self._rate

    def state_dict(self):
        d = super().state_dict()
        d.update(mode=self.mode, factor=self.factor, patience=self.patience,
                 best=self.best, num_bad=self.num_bad)
        return d

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        self.mode = state_dict["mode"]
        self.factor = state_dict["factor"]
        self.patience = state_dict["patience"]
        self.best = state_dict["best"]
        self.num_bad = state_dict["num_bad"]


class StepDecayScheduler(BaseScheduler):
    """StepLR equivalent: rate *= gamma every `step_size` epochs
    (joeynmt/builders.py:188-192; stepped at epoch)."""

    def __init__(self, initial_rate: float, step_size: int = 1, gamma: float = 0.1):
        super().__init__()
        self._rate = initial_rate
        self.step_size = step_size
        self.gamma = gamma
        self._epochs = 0

    def step(self, step: int) -> float:
        self._epochs += 1
        if self._epochs % self.step_size == 0:
            self._rate = self._rate * self.gamma
        return self._rate

    def _compute_rate(self):
        return self._rate

    def state_dict(self):
        d = super().state_dict()
        d.update(step_size=self.step_size, gamma=self.gamma, epochs=self._epochs)
        return d

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        self.step_size = state_dict["step_size"]
        self.gamma = state_dict["gamma"]
        self._epochs = state_dict["epochs"]


class ExponentialDecayScheduler(StepDecayScheduler):
    """ExponentialLR equivalent: rate *= gamma each epoch
    (joeynmt/builders.py:193-197)."""

    def __init__(self, initial_rate: float, gamma: float = 0.99):
        super().__init__(initial_rate, step_size=1, gamma=gamma)


def build_scheduler(cfg: Dict, scheduler_mode: str,
                    hidden_size: int = 0) -> Tuple[Optional[BaseScheduler], str]:
    """joeynmt/builders.py:139-250 — returns (scheduler, step_at)."""
    scheduler, scheduler_step_at = None, None
    scheduler_name = cfg.get("scheduling", None)
    lr = cfg.get("learning_rate", 3.0e-4)

    if scheduler_name is None:
        return None, "none"
    if scheduler_name == "plateau":
        scheduler = PlateauScheduler(
            initial_rate=lr, mode=scheduler_mode,
            factor=cfg.get("decrease_factor", 0.1),
            patience=cfg.get("patience", 10))
        scheduler_step_at = "validation"
    elif scheduler_name == "decaying":
        scheduler = StepDecayScheduler(
            initial_rate=lr, step_size=cfg.get("decaying_step_size", 1))
        scheduler_step_at = "epoch"
    elif scheduler_name == "exponential":
        scheduler = ExponentialDecayScheduler(
            initial_rate=lr, gamma=cfg.get("decrease_factor", 0.99))
        scheduler_step_at = "epoch"
    elif scheduler_name == "noam":
        scheduler = NoamScheduler(
            hidden_size=hidden_size, factor=cfg.get("learning_rate_factor", 1),
            warmup=cfg.get("learning_rate_warmup", 4000))
        scheduler_step_at = "step"
    elif scheduler_name == "warmupexponentialdecay":
        scheduler = WarmupExponentialDecayScheduler(
            min_rate=cfg.get("learning_rate_min", 1.0e-5),
            decay_rate=cfg.get("learning_rate_decay", 0.1),
            warmup=cfg.get("learning_rate_warmup", 4000),
            peak_rate=cfg.get("learning_rate_peak", 1.0e-3),
            decay_length=cfg.get("learning_rate_decay_length", 10000))
        scheduler_step_at = "step"
    elif scheduler_name == "warmupinversesquareroot":
        peak_rate = cfg.get("learning_rate_peak", lr)
        scheduler = WarmupInverseSquareRootScheduler(
            peak_rate=peak_rate, min_rate=cfg.get("learning_rate_min", 1.0e-5),
            warmup=cfg.get("learning_rate_warmup", 10000))
        scheduler_step_at = "step"
    else:
        raise ConfigurationError(
            "Invalid scheduler. Valid options: 'plateau', 'decaying', "
            "'exponential', 'noam', 'warmupexponentialdecay', "
            "'warmupinversesquareroot'.")

    return scheduler, scheduler_step_at
