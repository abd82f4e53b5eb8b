"""A frozen copy of `zeggs_tpu_torch/train/radam.py` for the benchmark's plain reference.

Rectified Adam, step for step as `zeggs_tpu/train/radam.py` (the
reference's vendored RAdam): variance rectification with the bias-corrected
SGD step while the SMA length N_sma < 5, and the denominator sqrt(v) + eps
without second-moment bias correction. The rectification is a function of
the integer step, so no per-step cache is kept.

The state is the JAX package's leaf for leaf: a step count and the two
moments of every parameter, which the checkpoints in both directions need
(`io.weights.opt_state_to_jax`).

An update is split so that a CUDA graph can hold it (`train/programs.py`):
`RAdam.scalars` computes the step's scalars on the host, in float32 and in
the reference's order, and `RAdam.apply` runs the update over the tensor
lists with those scalars read from a device tensor, with no host sync and
no branch. Both branches are one formula, p += a * m / (sqrt(v) + eps) +
c * m: the rectified steps have (a, c) = (-lr * rect, 0), the SGD steps
(N_sma < 5, steps 1-5) (0, -lr / bias1), so one graph runs every step.
`RAdam.step` is the eager update: the same scalars through the same
`apply`.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def exponential_step_schedule(base_lr, decay, every=1000):
    """lr(step) = base_lr * decay ** floor(step / every): the reference's
    ExponentialLR stepped once per 1000 iterations."""

    def schedule(step):
        return base_lr * decay ** math.floor(step / every)

    return schedule


class RAdam:
    """RAdam over named parameters ({name: tensor}), with ``learning_rate`` a
    float or a schedule of the step count before the update."""

    def __init__(self, params, learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0):
        if not eps > 0.0:
            # the SGD steps compute the rectified quotient m / (sqrt(v) + eps)
            # too, and zero it: it must stay finite
            raise ValueError(f"RAdam needs eps > 0, got {eps}")
        self.params = dict(params)
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.step_count = 0
        self.exp_avg = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.exp_avg_sq = {k: torch.zeros_like(p) for k, p in self.params.items()}

    def scalars(self, step=None):
        """The scalars of update number ``step`` (default: the next one,
        ``step_count + 1``) as float32 (3,): (a, c, d), where the update is
        p += a * m / (sqrt(v) + eps) + c * m + d * p_old. Computed on the
        host in float32, in the reference's order of operations: N_sma is a
        difference of numbers near 2000, and its float32 rounding shows in
        the first rectified steps."""
        t = self.step_count + 1 if step is None else int(step)
        lr = self.learning_rate
        lr = lr(t - 1) if callable(lr) else lr  # the schedule of the count before the update
        f32 = np.float32
        b1, b2 = self.b1, self.b2
        lr, stepf = f32(lr), f32(t)
        beta2_t = f32(b2) ** stepf
        n_sma_max = f32(2.0 / (1.0 - b2) - 1.0)
        n_sma = n_sma_max - f32(2.0) * stepf * beta2_t / (f32(1.0) - beta2_t)
        bias1 = f32(1.0) - f32(b1) ** stepf
        a = c = f32(0.0)
        if n_sma >= 5.0:
            rect = np.sqrt(np.maximum(
                (f32(1.0) - beta2_t) * (n_sma - f32(4.0)) / (n_sma_max - f32(4.0))
                * (n_sma - f32(2.0)) / n_sma * n_sma_max / (n_sma_max - f32(2.0)), f32(0.0)
            )) / bias1
            a = -lr * rect
        else:
            c = -lr * (f32(1.0) / bias1)
        d = -lr * f32(self.weight_decay)
        return np.array([a, c, d], np.float32)

    @torch.no_grad()
    def apply(self, scalars, grads=None):
        """The update with ``scalars`` (a (3,) float32 tensor on the
        parameters' device, `scalars`'s values) and ``grads`` ({name:
        tensor}; the parameters' .grad by default). Every operation is a
        fused list operation over all parameters; the scalars are read on
        the device, so the update can be captured in a CUDA graph. The step
        count is the caller's to advance."""
        b1, b2 = self.b1, self.b2
        names = list(self.params)
        params = [self.params[k] for k in names]
        g = [grads[k] for k in names] if grads is not None else [p.grad for p in params]
        m = [self.exp_avg[k] for k in names]
        v = [self.exp_avg_sq[k] for k in names]

        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1 - b2)
        if self.weight_decay != 0.0:
            decayed = torch._foreach_mul(params, scalars[2])
        # the list operations with a tensor scalar that run on the device
        # without a sync are the products, so the branch is a sum of two
        # products: one of them is zero
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(m, denom)
        torch._foreach_mul_(update, scalars[0])
        torch._foreach_add_(params, update)
        sgd = torch._foreach_mul(m, scalars[1])
        torch._foreach_add_(params, sgd)
        if self.weight_decay != 0.0:
            torch._foreach_add_(params, decayed)

    def step(self, grads=None):
        """One eager update from ``grads`` ({name: tensor}; the parameters'
        .grad by default)."""
        device = next(iter(self.params.values())).device
        self.apply(torch.from_numpy(self.scalars()).to(device), grads)
        self.step_count += 1

    def state(self):
        """(step, exp_avg, exp_avg_sq)."""
        return self.step_count, self.exp_avg, self.exp_avg_sq

    @torch.no_grad()
    def load_state(self, step, exp_avg, exp_avg_sq):
        """Restore a state of the same parameters (tensors on any device)."""
        if set(exp_avg) != set(self.params) or set(exp_avg_sq) != set(self.params):
            raise ValueError("optimizer state mismatch on resume")
        self.step_count = int(step)
        for k in self.params:
            self.exp_avg[k].copy_(exp_avg[k])
            self.exp_avg_sq[k].copy_(exp_avg_sq[k])
