# coding: utf-8
"""
Pipeline parallelism: GPipe over the pipe group (counterpart of
joeys2t_tpu/parallel/pp.py ``pipeline_apply`` :36-171).

A homogeneous layer stack of L layers runs in S stages of L / S layers, one
stage a rank of the pipe group, on M microbatches of the batch (M divides
the batch). Every rank of the group holds the same batch and the same
parameters (they stay replicated, as JAX's ``_place_params`` keeps them);
stage s runs only its own layers. The forward goes microbatch by
microbatch: stage 0 takes microbatch m, every later stage receives it from
the stage before, runs its layers and hands it on, so stage s works on
microbatch t - s at step t, the M + S - 1 step fill/drain order of GPipe.
JAX computes every stage at every step and masks the idle ones out; the
host here knows the schedule and skips them, with the same results. The
last stage's outputs are broadcast to the group, whose ranks then go on
alike.

The backward runs the same chain in reverse: the last stage takes the
cotangent of the broadcast output once (every rank holds the same one; a
sum over the ranks would count it S times), each stage backpropagates its
layers microbatch by microbatch and sends the input's cotangent to the
stage before; stage 0 broadcasts the cotangent of the pipeline's input, so
the replicated layers before the stack get the same gradient on every
rank, and the gradients of replicated side inputs (the encoder memory of a
staged decoder) are summed over the group, each stage adding its layers'
part. A stage's layer parameters get their gradients on that stage only;
the trainer sums them over the pipe group.

Point-to-point messages over gloo go through host memory (gloo sends
host tensors); over NCCL they stay on the card.
"""
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist


class PipePlan:
    """This rank's place in its pipe group: ``stage`` of ``n_stages``, the
    group's global ``ranks`` in stage order, ``n_micro`` microbatches."""

    def __init__(self, group, ranks: Sequence[int], stage: int, n_micro: int):
        self.group, self.ranks = group, list(ranks)
        self.stage, self.n_stages, self.n_micro = stage, len(ranks), n_micro

    def stage_slice(self, n_layers: int) -> slice:
        """The layers of this stage: n_layers / S of them, in order."""
        if n_layers % self.n_stages:
            raise ValueError(f"{n_layers} layers do not split into {self.n_stages} stages")
        per = n_layers // self.n_stages
        return slice(self.stage * per, (self.stage + 1) * per)


def _host_staged(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it travels: a host tensor over gloo."""
    x = x.detach()
    return (x.cpu() if _host_staged(group) else x).contiguous()


def _send(x: torch.Tensor, dst: int, group) -> None:
    dist.send(_wire(x, group), dst, group=group)


def _recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    buf = _wire(torch.empty_like(like), group)
    dist.recv(buf, src, group=group)
    return buf.to(like.device)


def _broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    buf = _wire(x, group)
    dist.broadcast(buf, src, group=group)
    return buf.to(x.device)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group (a bfloat16 tensor summed in float32)."""
    y = x.float() if x.dtype == torch.bfloat16 else x.clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _Pipeline(torch.autograd.Function):
    """The pipelined stack as one autograd node: the forward and the
    backward each run their whole schedule (see the module's docstring)."""

    @staticmethod
    def forward(ctx, run, plan, batched, x, *aux):  # pylint: disable=arguments-differ
        m, s, last = plan.n_micro, plan.stage, plan.n_stages - 1
        if x.shape[0] % m:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split into {m} "
                             f"microbatches (pipeline_microbatches)")
        xs = x.chunk(m)
        aux_mb = [a.chunk(m) if split else [a] * m for a, split in zip(aux, batched)]
        saved, outs = [], []
        for i in range(m):
            inp = (xs[i].detach() if s == 0 else
                   _recv(xs[i], plan.ranks[s - 1], plan.group)).requires_grad_(True)
            leaves = [a[i].detach().requires_grad_(a[i].requires_grad) for a in aux_mb]
            with torch.enable_grad():
                out = run(inp, *leaves)
            saved.append((inp, leaves, out))
            if s < last:
                _send(out, plan.ranks[s + 1], plan.group)
            else:
                outs.append(out.detach())
        y = torch.cat(outs) if s == last else torch.empty_like(x)
        ctx.plan, ctx.saved = plan, saved
        ctx.aux_grad = [a.requires_grad for a in aux]
        ctx.batched = batched
        return _broadcast(y, plan.ranks[last], plan.group)

    @staticmethod
    def backward(ctx, grad_y):  # pylint: disable=arguments-differ
        plan, saved = ctx.plan, ctx.saved
        m, s, last = plan.n_micro, plan.stage, plan.n_stages - 1
        gs = grad_y.contiguous().chunk(m)
        grad_x: List[torch.Tensor] = [None] * m
        aux_grads = [[] for _ in ctx.aux_grad]
        for i in reversed(range(m)):
            inp, leaves, out = saved[i]
            go = gs[i] if s == last else _recv(gs[i], plan.ranks[s + 1], plan.group)
            torch.autograd.backward(out, go)
            g_in = torch.zeros_like(inp) if inp.grad is None else inp.grad
            if s > 0:
                _send(g_in, plan.ranks[s - 1], plan.group)
            else:
                grad_x[i] = g_in
            for k, leaf in enumerate(leaves):
                if ctx.aux_grad[k]:
                    aux_grads[k].append(torch.zeros_like(leaf) if leaf.grad is None
                                        else leaf.grad)
        ctx.saved = None
        first = torch.cat(grad_x) if s == 0 else torch.empty_like(grad_y)
        grad_x_all = _broadcast(first, plan.ranks[0], plan.group)
        out = []
        for k, wants in enumerate(ctx.aux_grad):
            if not wants:
                out.append(None)
                continue
            parts = aux_grads[k][::-1]  # microbatch order
            g = torch.cat(parts) if ctx.batched[k] else torch.stack(parts).sum(0)
            out.append(_sum(g, plan.group))
        return (None, None, None, grad_x_all, *out)


def pipeline_apply(run: Callable, x: torch.Tensor, plan: PipePlan,
                   *aux: torch.Tensor) -> torch.Tensor:
    """``run(h, *aux_mb)`` (this stage's layers) over ``x`` (B, ...),
    pipelined over the plan's stages in its microbatches; returns the last
    stage's output, the same on every rank of the group, differentiable
    with respect to ``x`` and the ``aux`` tensors. An ``aux`` whose dim 0 is
    the batch is split into the microbatches (masks, the encoder memory),
    any other is passed whole."""
    batched = tuple(a.dim() >= 1 and a.shape[0] == x.shape[0] for a in aux)
    return _Pipeline.apply(run, plan, batched, x, *aux)
