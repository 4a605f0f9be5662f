"""Trainer — counterpart of ``cmrtpu/train/trainer.py``: the model, loss,
metrics and optimizer of one fold, and the epoch/callback loop over the
device-resident data loop.

The model comes from ``get_model`` and is initialised from a seeded
``torch.Generator`` (SEED); dropout masks come from a second seeded
generator on the card. Logs, callback order and the ``val_`` prefixing are
cmrtpu's, so ``history.csv`` has the same columns.
"""

from __future__ import annotations

import logging
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from cmrtpu_torch import config as C
from cmrtpu_torch.models.hybrids import get_model
from cmrtpu_torch.predict.predictor import resolve_device
from cmrtpu_torch.train import losses as L
from cmrtpu_torch.train.callbacks import Callback
from cmrtpu_torch.train.optimizers import (get_learning_rate, get_optimizer,
                                           set_learning_rate)
from cmrtpu_torch.train.steps import TrainState


def init_model(config: Dict) -> torch.nn.Module:
    """The configured model with the reference's initialisers, drawn from a
    generator seeded with SEED (on the CPU, so every device gets the same
    weights)."""
    seed = int(C.get(config, "SEED", 42))
    return get_model(config).reset_parameters(
        torch.Generator().manual_seed(seed))


def _check_config(cfg: Dict) -> None:
    """Keys whose values the port does not train with raise; REMAT changes
    memory only and is warned about."""
    if C.get(cfg, "QUANT_INT8", False):
        raise ValueError(
            "QUANT_INT8 configs are serving-only twins: round/clip "
            "quantization has zero gradient, so training one would silently "
            "not learn — train the float config and quantize the result")
    pad = str(C.get(cfg, "PAD", "same")).lower()
    if pad != "same":
        raise NotImplementedError(
            f"PAD={pad!r}: the U-Net pads 'same' only, as cmrtpu's does")
    init = str(C.get(cfg, "KERNEL_INIT", "he_normal")).lower()
    if init != "he_normal":
        raise NotImplementedError(
            f"KERNEL_INIT={init!r}: the U-Net initialises he_normal only, "
            "as cmrtpu's does")
    if C.get(cfg, "REMAT", False):
        logging.warning("REMAT trades memory for recompute in cmrtpu's "
                        "backward pass; cmrtpu_torch keeps every activation "
                        "(ROADMAP skip list)")


class Trainer:
    def __init__(self, config: Dict, model: Optional[torch.nn.Module] = None,
                 device="cuda", loss_fn: Optional[Callable] = None,
                 metrics: Optional[Dict[str, Callable]] = None):
        self.config = C.normalise_config(config)
        _check_config(self.config)
        self.device = resolve_device(device)
        if model is None:
            model = init_model(self.config)
        self.model = model.to(self.device)
        self.loss_fn = loss_fn or L.get_loss(self.config)
        self.metrics = metrics if metrics is not None else L.default_metrics(
            C.get(self.config, "MASK_CLASSES"))
        if metrics is None and C.get(self.config, "MONITOR_LOCALISATION",
                                     False):
            if C.get(self.config, "HEADS", ()) or C.ndims(self.config) != 2:
                raise ValueError(
                    "MONITOR_LOCALISATION covers single-head 2D landmark "
                    "configs (the slice-wise detection contract)")
            from cmrtpu_torch.eval.detection import localisation_metrics
            self.metrics = dict(self.metrics,
                                **localisation_metrics(self.config))
        heads = C.get(self.config, "HEADS", ()) or ()
        if heads and metrics is None:
            # tensor metrics run on the channel-concatenated head outputs
            concat = L.concat_heads(heads)
            self.metrics = {name: (lambda yt, yp, f=fn: f(yt, concat(yp)))
                            for name, fn in self.metrics.items()}
        self.optimizer = get_optimizer(self.model.parameters(), self.config)
        self.generator = torch.Generator(self.device).manual_seed(
            int(C.get(self.config, "SEED", 42)))
        self.state = TrainState(self.model, self.optimizer, self.loss_fn,
                                self.metrics, self.generator, self.config)
        self.stop_training = False
        self.history: List[Dict[str, float]] = []

    def get_lr(self) -> float:
        return get_learning_rate(self.optimizer)

    def set_lr(self, lr: float) -> None:
        set_learning_rate(self.optimizer, lr)

    @property
    def serving_params(self) -> Dict[str, torch.Tensor]:
        """Weights for inference-time consumers (the live ones; EMA is not
        ported)."""
        return self.model.state_dict()

    def _fit_loop(self, train_epoch: Callable[[], Dict[str, float]],
                  eval_epoch: Optional[Callable[[], Dict[str, float]]],
                  epochs: Optional[int], callbacks: Optional[List[Callback]],
                  initial_epoch: int) -> List[Dict[str, float]]:
        """The epoch/callback/early-stop loop: callbacks in list order,
        eval logs merged under ``val_``, ``epoch_time``, and on_train_end
        even when an epoch raises."""
        epochs = epochs or C.get(self.config, "EPOCHS", 100)
        callbacks = callbacks or []
        self.stop_training = False
        for cb in callbacks:
            cb.on_train_begin(self)
        try:
            for epoch in range(initial_epoch, epochs):
                t0 = time.time()
                for cb in callbacks:
                    cb.on_epoch_begin(self, epoch)
                logs = train_epoch()
                if eval_epoch is not None:
                    logs.update({f"val_{k}": v
                                 for k, v in eval_epoch().items()})
                logs["epoch_time"] = time.time() - t0
                self.history.append(logs)
                for cb in callbacks:
                    cb.on_epoch_end(self, epoch, logs)
                logging.info("epoch %d/%d %s", epoch + 1, epochs,
                             " ".join(f"{k}={v:.4f}"
                                      for k, v in sorted(logs.items())))
                if self.stop_training:
                    break
        finally:
            self._end_callbacks(callbacks)
        return self.history

    def _end_callbacks(self, callbacks) -> None:
        """on_train_end for every callback. With an epoch-loop exception in
        flight, callback errors are logged (never mask the original); on the
        clean path a failing on_train_end (e.g. the final checkpoint write)
        fails the fold."""
        in_flight = sys.exc_info()[0] is not None
        first_error = None
        for cb in callbacks:
            try:
                cb.on_train_end(self)
            except Exception as e:
                logging.error("on_train_end callback failed: %s", e)
                if first_error is None:
                    first_error = e
        if first_error is not None and not in_flight:
            raise first_error

    def fit_cached(self, train_gen, val_gen=None, epochs: Optional[int] = None,
                   callbacks: Optional[List[Callback]] = None,
                   initial_epoch: int = 0) -> List[Dict[str, float]]:
        """Train from data held in the card's memory (see
        cmrtpu_torch/train/device_cache.py): the cache is uploaded once and
        each step gathers, augments, builds targets and trains on the card."""
        from cmrtpu_torch.train.device_cache import DeviceCachedLoop

        loop = DeviceCachedLoop(self, train_gen, val_gen)
        return self._fit_loop(loop.run_train_epoch,
                              loop.run_eval_epoch if loop.val else None,
                              epochs, callbacks, initial_epoch)
