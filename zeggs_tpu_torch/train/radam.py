"""Rectified Adam, step for step as `zeggs_tpu/train/radam.py` (the
reference's vendored RAdam): variance rectification with the bias-corrected
SGD step while the SMA length N_sma < 5, and the denominator sqrt(v) + eps
without second-moment bias correction. The rectification is a function of
the integer step, so no per-step cache is kept.

The state is the JAX package's leaf for leaf: a step count and the two
moments of every parameter, which the checkpoints in both directions need
(`io.weights.opt_state_to_jax`).
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
        self.params = dict(params)
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.step_count = 0
        self.exp_avg = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.exp_avg_sq = {k: torch.zeros_like(p) for k, p in self.params.items()}

    def lr(self):
        lr = self.learning_rate
        return lr(self.step_count) if callable(lr) else lr

    @torch.no_grad()
    def step(self, grads=None):
        """One update from ``grads`` ({name: tensor}; the parameters' .grad
        by default). The moment updates and the step are one fused list
        operation each over all parameters."""
        b1, b2 = self.b1, self.b2
        names = list(self.params)
        params = [self.params[k] for k in names]
        g = [grads[k] for k in names] if grads is not None else [p.grad for p in params]
        m = [self.exp_avg[k] for k in names]
        v = [self.exp_avg_sq[k] for k in names]
        lr = self.lr()
        self.step_count += 1
        t = self.step_count

        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1 - b2)

        # the step's scalars in float32, in the reference's order of operations:
        # N_sma is a difference of numbers near 2000, and its float32 rounding
        # shows in the first rectified steps
        f32 = np.float32
        lr, stepf = f32(lr), f32(t)
        beta2_t = f32(b2) ** stepf
        n_sma_max = f32(2.0 / (1.0 - b2) - 1.0)
        n_sma = n_sma_max - f32(2.0) * stepf * beta2_t / (f32(1.0) - beta2_t)
        bias1 = f32(1.0) - f32(b1) ** stepf
        if self.weight_decay != 0.0:
            decayed = torch._foreach_mul(params, -lr * self.weight_decay)
        if n_sma >= 5.0:
            rect = np.sqrt(np.maximum(
                (f32(1.0) - beta2_t) * (n_sma - f32(4.0)) / (n_sma_max - f32(4.0))
                * (n_sma - f32(2.0)) / n_sma * n_sma_max / (n_sma_max - f32(2.0)), f32(0.0)
            )) / bias1
            denom = torch._foreach_sqrt(v)
            torch._foreach_add_(denom, self.eps)
            torch._foreach_addcdiv_(params, m, denom, value=float(-lr * rect))
        else:
            torch._foreach_add_(params, m, alpha=float(-lr * (f32(1.0) / bias1)))
        if self.weight_decay != 0.0:
            torch._foreach_add_(params, decayed)

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
