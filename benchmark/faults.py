"""Faults planted under a run's timed path, to show that the correctness
check rejects each one a cell can have. A training fault takes the
program's (trainer, loop), a serving fault its engine; each changes only
that object.
"""

from __future__ import annotations

import torch


def train_unchanged(trainer, loop) -> None:
    """A step that returns its state unchanged: the optimizer applies
    nothing."""
    trainer.optimizer.step = lambda *a, **k: None


def train_half_batch(trainer, loop) -> None:
    """Half of the batch left out: the loss is the mean over the first
    half of the rows."""
    loss = trainer.state.loss_fn

    def half(y, p):
        n = max(1, y.shape[0] // 2)
        return loss(y[:n], p[:n])

    trainer.state.loss_fn = half


def serve_altered(engine) -> None:
    """An answer altered where it is produced: the filtered label map
    shifted by one voxel along x."""
    cc = engine._cc

    def shifted(flat, values, device=None):
        return torch.roll(cc(flat, values, device=device), 1, dims=-1)

    engine._cc = shifted


def serve_cc_bypassed(engine) -> None:
    """The CC filter (K2) skipped: every component of the thresholded map
    is written."""
    def keep_all(flat, values, device=None):
        return torch.as_tensor(flat)

    engine._cc = keep_all


def serve_half_batch(engine) -> None:
    """Half of the batch left out: the forward's second half of rows comes
    back as zeros."""
    forward = engine._forward

    def half(x):
        out = forward(x)
        h = x.shape[0] // 2
        return torch.cat([out[:h], torch.zeros_like(out[h:])])

    engine._forward = half


TRAIN = {"unchanged": train_unchanged, "half_batch": train_half_batch}
SERVE = {"altered": serve_altered, "half_batch": serve_half_batch,
         "cc_bypassed": serve_cc_bypassed}
