# coding: utf-8
"""
Gradient clipping, optimizers and learning-rate schedulers (counterpart of
joeys2t_tpu/optim.py).

Clipping follows optax: global-norm clipping scales the gradients by
``max_norm / ||g||`` when ``||g|| >= max_norm`` (not ``clip_grad_norm_``'s
``max_norm / (||g|| + 1e-6)``), computed on the device without a host sync.
Adam and AdamW are the port's own :class:`Adam`, optax's ``scale_by_adam``
step in ``torch._foreach_*`` operations: eps 1e-8 outside the square root
(eps_root 0), the bias corrections in float32, Adam's L2 term added to the
raw gradients (``add_decayed_weights`` before ``scale_by_adam``) and AdamW's
decoupled decay applied as ``-lr * (adam + wd * theta)``; ``moment_dtype``
keeps the first moment in that dtype (optax's ``mu_dtype``: the moment is
updated and used in float32 and stored cast; the second moment stays
float32), which ``torch.optim.Adam`` cannot.

The other optimizers are JAX's chains (joeys2t_tpu/optim.py:93-158), one
``torch.optim.Optimizer`` each, with optax 0.2.6's defaults:
  - :class:`SGD`: L2 decay, then ``optax.trace(momentum)`` (g + m * trace)
    when ``momentum`` > 0, then -lr;
  - :class:`Adagrad`: L2 decay, ``scale_by_rss`` (initial accumulator 0,
    eps 1e-7: g / sqrt(sum g^2 + eps) where the sum is positive), -lr;
  - :class:`Adadelta`: L2 decay, ``scale_by_adadelta`` (rho 0.9, eps 1e-6),
    -lr;
  - :class:`RMSprop`: L2 decay, ``scale_by_rms`` (decay 0.9, eps 1e-8 inside
    the square root, initial 0, no bias correction), -lr;
  - :class:`Adafactor`: ``scale_by_factored_rms`` (decay rate 0.8 through
    1 - t^-0.8, epsilon 1e-30, a parameter factored over its two largest
    dims when the smaller is >= 128), ``clip_by_block_rms(1.0)`` per
    parameter, times lr, then the decoupled decay (+ wd * theta, not scaled
    by lr), and the sign flipped. Under tensor parallelism its statistics
    are the whole parameter's, as JAX's GSPMD computes them on the global
    array: a mean along the split dim and the block RMS are summed over the
    model group (``shard_dims``, ``shard_group``).
Their states load with ``state_dict``; :func:`state_split_dim` says which
dim of each state entry a tensor-parallel shard splits. The trainer writes
the scheduler's rate into the optimizer before each update. The schedulers
are plain Python, as in the JAX package (joeynmt/builders.py:253-485), with
their ``state_dict``.
"""
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from joeys2t_torch.config import OPTIMIZERS, ConfigurationError


class GlobalNormClipper:
    """optax.clip_by_global_norm: g <- (g / ||g||) * max_norm unless
    ||g|| < max_norm, with ||g|| over all gradients together. Under tensor
    parallelism the squares of the sharded gradients (``sharded``) are
    summed over the model group (``group``), those of the replicated ones
    counted once."""

    def __init__(self, max_norm: float):
        self.max_norm = float(max_norm)

    def __call__(self, grads: List[torch.Tensor], sharded: Optional[List[bool]] = None,
                 group=None) -> torch.Tensor:
        """Clip ``grads`` in place; returns the global norm before clipping
        (a device scalar)."""
        squares = torch.stack(torch._foreach_norm(grads)).square()
        if sharded is None:
            norm = squares.sum().sqrt()
        else:
            mask = torch.tensor(sharded, device=squares.device)
            split = squares[mask].sum()
            torch.distributed.all_reduce(split, group=group)
            norm = (split + squares[~mask].sum()).sqrt()
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


class Adam(torch.optim.Optimizer):
    """optax's Adam (``decoupled`` False: the L2 term on the gradients) or
    AdamW (``decoupled`` True: the decay added to Adam's direction), with
    the first moment kept in ``moment_dtype``. Its state per parameter is
    ``torch.optim.Adam``'s (``step`` a host float tensor, ``exp_avg``,
    ``exp_avg_sq``), so checkpoints of either load into the other."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, decoupled: bool = False,
                 moment_dtype: Optional[torch.dtype] = None):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, decoupled=decoupled))
        self.moment_dtype = moment_dtype
        self._count = None  # updates so far, as optax's one count; read from the state

    def load_state_dict(self, state_dict) -> None:  # noqa: D102
        super().load_state_dict(state_dict)
        self._count = None

    @torch.no_grad()
    def step(self, closure=None):  # noqa: D102 - torch.optim.Optimizer.step
        if closure is not None:
            raise ValueError("Adam takes no closure")
        if self._count is None:  # the first update, or the first after a load
            self._count = int(max((st["step"].item() for st in self.state.values()
                                   if "step" in st), default=0))
        self._count += 1
        count = self._count
        step = torch.tensor(float(count))  # one host tensor for every parameter's state
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            grads = [p.grad for p in params]
            decoupled = group.get("decoupled", self.defaults["decoupled"])
            if wd and not decoupled:
                grads = torch._foreach_add(grads, params, alpha=wd)
            states = [self._state(p) for p in params]
            for st in states:
                st["step"] = step
            # mu <- (1 - b1) g + b1 mu and nu <- (1 - b2) g^2 + b2 nu in float32;
            # a stored bfloat16 mu enters as optax's b1 * mu does: the Python
            # float b1 is weakly typed, so JAX rounds it to bfloat16 and the
            # product too
            mus = [st["exp_avg"] for st in states]
            if mus[0].dtype == torch.float32:
                torch._foreach_mul_(mus, b1)
            else:
                b1_low = torch.tensor(b1, dtype=mus[0].dtype).item()
                mus = [m.float() for m in torch._foreach_mul(mus, b1_low)]
            nus = [st["exp_avg_sq"] for st in states]
            torch._foreach_add_(mus, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
            c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** count
            c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** count
            # mu_hat / (sqrt(nu_hat) + eps)
            denom = torch._foreach_div(nus, float(c2))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            updates = torch._foreach_div(mus, float(c1))
            torch._foreach_div_(updates, denom)
            if wd and decoupled:
                torch._foreach_add_(updates, params, alpha=wd)
            torch._foreach_add_(params, updates, alpha=-lr)
            for st, mu in zip(states, mus):
                if st["exp_avg"] is not mu:  # stored in moment_dtype
                    st["exp_avg"].copy_(mu)

    def _state(self, p: torch.Tensor) -> Dict:
        st = self.state[p]
        if not st:
            st["step"] = torch.tensor(0.0)  # a host tensor, as torch.optim.Adam's
            st["exp_avg"] = torch.zeros_like(p, dtype=self.moment_dtype or p.dtype)
            st["exp_avg_sq"] = torch.zeros_like(p)
        elif self.moment_dtype is not None and st["exp_avg"].dtype != self.moment_dtype:
            # load_state_dict casts the state to the parameter's dtype
            st["exp_avg"] = st["exp_avg"].to(self.moment_dtype)
        return st


class _Chain(torch.optim.Optimizer):
    """An optax chain as a torch optimizer: the count of updates (read back
    from the states' ``step`` after a load), the parameters with gradients,
    and their states, each made by :meth:`_init` at its first update."""

    def __init__(self, params, defaults):
        super().__init__(params, defaults)
        self._count = None

    def load_state_dict(self, state_dict) -> None:  # noqa: D102
        super().load_state_dict(state_dict)
        self._count = None

    def _next_count(self) -> int:
        if self._count is None:  # the first update, or the first after a load
            self._count = int(max((st["step"].item() for st in self.state.values()
                                   if "step" in st), default=0))
        self._count += 1
        return self._count

    def _init(self, p: torch.Tensor) -> Dict:
        return {}

    def _live(self, group, count: int):
        params = [p for p in group["params"] if p.grad is not None]
        step = torch.tensor(float(count))  # one host tensor for every parameter
        states = []
        for p in params:
            st = self.state[p]
            if not st:
                st.update(self._init(p))
            st["step"] = step
            states.append(st)
        return params, states

    @staticmethod
    def _decayed(group, params) -> List[torch.Tensor]:
        """The gradients with optax's ``add_decayed_weights`` first in the
        chain: g + wd * theta."""
        grads = [p.grad for p in params]
        if group["weight_decay"]:
            grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
        return grads


class SGD(_Chain):
    """optax's ``trace`` chain: (g + wd * theta), accumulated as trace <-
    g + momentum * trace when ``momentum`` > 0, times -lr."""

    def __init__(self, params, lr: float = 1e-3, momentum: float = 0.0,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum, weight_decay=weight_decay))

    def _init(self, p):
        return {"momentum_buffer": torch.zeros_like(p)} if self.defaults["momentum"] else {}

    @torch.no_grad()
    def step(self, closure=None):  # noqa: D102
        count = self._next_count()
        for group in self.param_groups:
            params, states = self._live(group, count)
            if not params:
                continue
            updates = self._decayed(group, params)
            if group["momentum"]:
                traces = [st["momentum_buffer"] for st in states]
                torch._foreach_mul_(traces, group["momentum"])
                torch._foreach_add_(traces, updates)
                updates = traces
            torch._foreach_add_(params, updates, alpha=-group["lr"])


# optax 0.2.6's defaults, which JAX's chains take (joeys2t_tpu/optim.py:93-158)
ADAGRAD_EPS = 1e-7  # scale_by_rss
ADADELTA_RHO, ADADELTA_EPS = 0.9, 1e-6  # scale_by_adadelta
RMSPROP_DECAY, RMSPROP_EPS = 0.9, 1e-8  # scale_by_rms
# scale_by_factored_rms and clip_by_block_rms(1.0)
FACTORED_DECAY_RATE, FACTORED_EPSILON, MIN_DIM_SIZE_TO_FACTOR, BLOCK_RMS = 0.8, 1e-30, 128, 1.0


class Adagrad(_Chain):
    """optax's ``scale_by_rss`` (initial accumulator 0): sum <- sum + g^2,
    g / sqrt(sum + eps) where sum > 0, else 0; times -lr."""

    def __init__(self, params, lr: float = 1e-3, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))

    def _init(self, p):
        return {"sum": torch.zeros_like(p)}

    @torch.no_grad()
    def step(self, closure=None):  # noqa: D102
        count = self._next_count()
        for group in self.param_groups:
            params, states = self._live(group, count)
            if not params:
                continue
            grads = self._decayed(group, params)
            sums = [st["sum"] for st in states]
            torch._foreach_addcmul_(sums, grads, grads)
            for p, g, total in zip(params, grads, sums):
                scale = torch.where(total > 0, torch.rsqrt(total + ADAGRAD_EPS),
                                    torch.zeros_like(total))
                p.add_(scale * g, alpha=-group["lr"])


class Adadelta(_Chain):
    """optax's ``scale_by_adadelta``: E[g^2] and E[u^2] averaged with rho,
    u = sqrt(E[u^2] + eps) / sqrt(E[g^2] + eps) * g, the update's average
    after it; times -lr."""

    def __init__(self, params, lr: float = 1e-3, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))

    def _init(self, p):
        return {"square_avg": torch.zeros_like(p), "acc_delta": torch.zeros_like(p)}

    @torch.no_grad()
    def step(self, closure=None):  # noqa: D102
        count = self._next_count()
        for group in self.param_groups:
            params, states = self._live(group, count)
            if not params:
                continue
            rho, eps = ADADELTA_RHO, ADADELTA_EPS
            grads = self._decayed(group, params)
            for p, g, st in zip(params, grads, states):
                e_g, e_x = st["square_avg"], st["acc_delta"]
                e_g.mul_(rho).add_(g * g * (1 - rho))
                u = torch.sqrt(e_x + eps) / torch.sqrt(e_g + eps) * g
                e_x.mul_(rho).add_(u * u * (1 - rho))
                p.add_(u, alpha=-group["lr"])


class RMSprop(_Chain):
    """optax's ``scale_by_rms`` (eps inside the square root, initial 0, no
    bias correction): nu <- (1 - d) g^2 + d nu, g / sqrt(nu + eps); times
    -lr."""

    def __init__(self, params, lr: float = 1e-3, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))

    def _init(self, p):
        return {"square_avg": torch.zeros_like(p)}

    @torch.no_grad()
    def step(self, closure=None):  # noqa: D102
        count = self._next_count()
        for group in self.param_groups:
            params, states = self._live(group, count)
            if not params:
                continue
            grads = self._decayed(group, params)
            nus = [st["square_avg"] for st in states]
            torch._foreach_mul_(nus, RMSPROP_DECAY)
            torch._foreach_addcmul_(nus, grads, grads, value=1 - RMSPROP_DECAY)
            denom = torch._foreach_add(nus, RMSPROP_EPS)
            torch._foreach_rsqrt_(denom)
            torch._foreach_mul_(denom, grads)
            torch._foreach_add_(params, denom, alpha=-group["lr"])


def factored_dims(shape) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: the (second largest, largest) dims of a
    parameter of ``shape`` when both are >= ``MIN_DIM_SIZE_TO_FACTOR``."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


class Adafactor(_Chain):
    """JAX's adafactor chain (joeys2t_tpu/optim.py:93-114): optax's
    ``scale_by_factored_rms`` (decay rate 1 - t^-0.8, epsilon 1e-30,
    factored when the two largest dims are >= 128),
    ``clip_by_block_rms(1.0)``, times lr, plus the decoupled decay wd *
    theta, the sign flipped.

    ``shard_dims`` maps a tensor-parallel shard to the dim it splits over
    ``shard_group`` (of ``shard_world`` ranks): its factored dims are the
    whole parameter's, and a mean along that dim and the block RMS are
    summed over the group."""

    def __init__(self, params, lr: float = 1e-3, weight_decay: float = 0.0,
                 shard_dims: Optional[Dict[torch.Tensor, int]] = None, shard_group=None,
                 shard_world: int = 1):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))
        self.shard_dims = shard_dims or {}
        self.shard_group, self.shard_world = shard_group, shard_world

    def whole_shape(self, p: torch.Tensor) -> Tuple[int, ...]:
        shape = list(p.shape)
        if p in self.shard_dims:
            shape[self.shard_dims[p]] *= self.shard_world
        return tuple(shape)

    def _init(self, p):
        dims = factored_dims(self.whole_shape(p))
        if dims is None:
            return {"v": torch.zeros_like(p)}
        d1, d0 = dims
        return {"v_row": p.new_zeros(p.shape[:d0] + p.shape[d0 + 1:]),
                "v_col": p.new_zeros(p.shape[:d1] + p.shape[d1 + 1:])}

    def _sum(self, x: torch.Tensor, p: torch.Tensor, dim=None) -> torch.Tensor:
        """A sum over ``dim`` (all of ``x`` when None) of the whole
        parameter's ``x``: over the model group where ``x`` is split along
        that dim."""
        split = self.shard_dims.get(p)
        total = x.sum() if dim is None else x.sum(dim)
        if split is not None and (dim is None or dim == split):
            dist.all_reduce(total, group=self.shard_group)
        return total

    def _mean(self, x, p, dim, whole_size: int) -> torch.Tensor:
        return self._sum(x, p, dim) / whole_size

    @torch.no_grad()
    def step(self, closure=None):  # noqa: D102
        count = self._next_count()
        for group in self.param_groups:
            params, states = self._live(group, count)
            decay = float(1.0 - torch.tensor(float(count), dtype=torch.float32)
                          ** -FACTORED_DECAY_RATE)
            for p, st in zip(params, states):
                g = p.grad
                shape = self.whole_shape(p)
                grad_sqr = g * g + FACTORED_EPSILON
                if "v" in st:
                    st["v"].mul_(decay).add_(grad_sqr * (1.0 - decay))
                    update = g * st["v"] ** -0.5
                else:
                    d1, d0 = factored_dims(shape)
                    v_row, v_col = st["v_row"], st["v_col"]
                    # v_row lives on the dims but d0, v_col on the dims but d1
                    row_split = self._shift(p, d0)
                    v_row.mul_(decay).add_(self._mean(grad_sqr, p, d0, shape[d0])
                                           * (1.0 - decay))
                    v_col.mul_(decay).add_(self._mean(grad_sqr, p, d1, shape[d1])
                                           * (1.0 - decay))
                    reduced_d1 = d1 - 1 if d1 > d0 else d1
                    row_sum = v_row.sum(dim=reduced_d1, keepdim=True)
                    if row_split is not None and row_split == reduced_d1:
                        dist.all_reduce(row_sum, group=self.shard_group)
                    row_col_mean = row_sum / shape[d1]
                    row_factor = (v_row / row_col_mean) ** -0.5
                    col_factor = v_col ** -0.5
                    update = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
                rms = torch.sqrt(self._sum(update * update, p) / float(np.prod(shape)))
                update = update / torch.clamp(rms / BLOCK_RMS, min=1.0)
                update = update * group["lr"]
                if group["weight_decay"]:
                    update = update + group["weight_decay"] * p
                p.sub_(update)

    def _shift(self, p, removed: int) -> Optional[int]:
        """The split dim of ``p`` in a statistic that lacks dim ``removed``
        (None where the statistic is the mean along the split dim)."""
        split = self.shard_dims.get(p)
        if split is None or split == removed:
            return None
        return split - 1 if split > removed else split


def state_split_dim(optimizer: torch.optim.Optimizer, key: str, value, dim: int,
                    whole_shape) -> Optional[int]:
    """The dim along which state entry ``key`` of a parameter split along
    ``dim`` (of shape ``whole_shape`` when whole) is split too, or None when
    every rank holds it whole (a scalar, or adafactor's mean along the split
    dim)."""
    if not torch.is_tensor(value) or value.dim() == 0:
        return None
    if key in ("v_row", "v_col") and isinstance(optimizer, Adafactor):
        d1, d0 = factored_dims(whole_shape)
        removed = d0 if key == "v_row" else d1
        return None if dim == removed else (dim - 1 if dim > removed else dim)
    return dim


def build_optimizer(cfg: Dict, params: Iterable[torch.nn.Parameter],
                    shard_dims: Optional[Dict[torch.Tensor, int]] = None, shard_group=None,
                    shard_world: int = 1) -> torch.optim.Optimizer:
    """The optimizer that the training config names (joeys2t_tpu/optim.py:51)
    over ``params``: Adam or AdamW with the first moment in
    ``moment_dtype``, or one of JAX's other chains; adafactor's statistics
    over the whole of each tensor-parallel shard in ``shard_dims``."""
    name = cfg.get("optimizer", "sgd").lower()
    if name not in OPTIMIZERS:
        raise ConfigurationError(
            "Invalid optimizer. Valid options: 'adam', 'adamw', 'adafactor', "
            "'adagrad', 'adadelta', 'rmsprop', 'sgd'.")
    lr = cfg.get("learning_rate", 3.0e-4)
    weight_decay = cfg.get("weight_decay", 0)
    if name in ("adam", "adamw"):
        moment_dtype = cfg.get("moment_dtype")
        return Adam(params, lr=lr, betas=tuple(cfg.get("adam_betas", (0.9, 0.999))),
                    eps=1e-8, weight_decay=weight_decay, decoupled=name == "adamw",
                    moment_dtype=None if moment_dtype is None else getattr(torch,
                                                                           moment_dtype))
    if name == "adafactor":
        return Adafactor(params, lr=lr, weight_decay=weight_decay, shard_dims=shard_dims,
                         shard_group=shard_group, shard_world=shard_world)
    if name == "sgd":
        return SGD(params, lr=lr, momentum=cfg.get("momentum", 0.0),
                   weight_decay=weight_decay)
    return {"adagrad": Adagrad, "adadelta": Adadelta, "rmsprop": RMSprop}[name](
        params, lr=lr, weight_decay=weight_decay)


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
