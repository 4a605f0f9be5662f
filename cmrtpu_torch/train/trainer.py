"""Trainer — counterpart of ``cmrtpu/train/trainer.py``: the model, loss,
metrics and optimizer of one fold, and the epoch/callback loop over the
device-resident data loop.

The model comes from ``get_model`` and is initialised from a seeded
``torch.Generator`` (SEED); dropout masks come from a second seeded
generator on the card (SEED), and the loop's augmentation and matcher
draws from a third (SEED + 1), which the Trainer owns so that a full-state
checkpoint holds both draw streams' positions: cmrtpu keys these draws on
the step, which a restore brings back, and the port restores the
generators' states instead. Logs, callback order and the ``val_``
prefixing are cmrtpu's, so ``history.csv`` has the same columns. The data
loops: ``fit_cached`` (the dataset on the card), ``fit_streamed`` (packed
host batches) and ``fit`` (finalized host batches).

Over a process group (``parallel/mesh.py``) the Trainer holds the mesh,
runs on ``cuda:LOCAL_RANK``, broadcasts rank 0's weights, buffers,
optimizer state and EMA shadow after init, ``restore`` and
``restore_weights`` (cmrtpu's ``_globalize_state``), trains each rank on
its rows of every batch, and hands the callbacks the epoch's logs
averaged over the ranks; training stops on every rank when one asks.
"""

from __future__ import annotations

import logging
import sys
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from cmrtpu_torch import config as C
from cmrtpu_torch.models.hybrids import get_model
from cmrtpu_torch.parallel import mesh as M
from cmrtpu_torch.predict.predictor import resolve_device, to_numpy
from cmrtpu_torch.train import checkpoint as ckpt
from cmrtpu_torch.train import losses as L
from cmrtpu_torch.train.callbacks import Callback
from cmrtpu_torch.train.optimizers import (get_learning_rate, get_optimizer,
                                           set_learning_rate)
from cmrtpu_torch.train.steps import TrainState


def init_model(config: Dict, supervision: bool = False) -> torch.nn.Module:
    """The configured model (MODEL_VARIANT; with the deep-supervision
    branch when ``supervision``) with the reference's initialisers, drawn
    from a generator seeded with SEED (on the CPU, so every device gets the
    same weights)."""
    seed = int(C.get(config, "SEED", 42))
    return get_model(config, supervision=supervision).reset_parameters(
        torch.Generator().manual_seed(seed))


def _check_config(cfg: Dict) -> None:
    """Keys whose values the port does not train with raise."""
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


class Trainer:
    def __init__(self, config: Dict, model: Optional[torch.nn.Module] = None,
                 device="cuda", loss_fn: Optional[Callable] = None,
                 metrics: Optional[Dict[str, Callable]] = None,
                 supervision: bool = False, mesh: Optional[M.Mesh] = None):
        self.config = C.normalise_config(config)
        _check_config(self.config)
        self.mesh = mesh if mesh is not None else M.create_mesh(self.config)
        self.device = resolve_device(device)
        if self.mesh.distributed and self.device.type == "cuda" \
                and self.device.index is None:  # the rank's card
            self.device = torch.device("cuda", torch.cuda.current_device())
        if model is None:
            model = init_model(self.config, supervision)
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
        self.optimizer = get_optimizer(self.model.named_parameters(),
                                       self.config)
        seed = int(C.get(self.config, "SEED", 42))
        self.generator = torch.Generator(self.device).manual_seed(seed)
        # the device-resident loop's augmentation and matcher draws
        self.loop_generator = torch.Generator(self.device).manual_seed(
            seed + 1)
        self.state = TrainState(self.model, self.optimizer, self.loss_fn,
                                self.metrics, self.generator, self.config,
                                mesh=self.mesh)
        self._broadcast_state()
        self.stop_training = False
        self.history: List[Dict[str, float]] = []

    def _broadcast_state(self) -> None:
        """Rank 0's weights, buffers, optimizer state and EMA shadow on
        every rank (no-op without a process group)."""
        if not self.mesh.distributed:
            return
        tensors = list(self.model.state_dict().values())
        tensors += [v for st in self.optimizer.state.values()
                    for v in st.values() if torch.is_tensor(v)]
        tensors += list((self.state.ema or {}).values())
        M.broadcast_(tensors, self.mesh)

    @property
    def optimizer_name(self) -> str:
        return self.optimizer.name

    def get_lr(self) -> float:
        return get_learning_rate(self.optimizer)

    def set_lr(self, lr: float) -> None:
        set_learning_rate(self.optimizer, lr)

    def switch_optimizer(self, name: str) -> None:
        """A fresh optimizer of rule ``name`` over the same weights, at the
        config's LEARNING_RATE (OptimizerChanger, ref:
        src/utils/KerasCallbacks.py:245-306)."""
        self.optimizer = get_optimizer(self.model.named_parameters(),
                                       dict(self.config, OPTIMIZER=name))
        self.state.optimizer = self.optimizer

    @property
    def serving_params(self) -> Dict[str, torch.Tensor]:
        """The state_dict inference-time consumers read (model.npz,
        WeightsSaver): the EMA shadow in place of the parameters when EMA
        is on, the live weights otherwise."""
        return {**self.model.state_dict(), **self.state.inference_params()}

    def predict(self, x: np.ndarray):
        """Eval-mode forward of a [N, *DIM, C] batch on the trainer's device
        from ``serving_params`` (the EMA shadow when EMA is on): numpy
        probabilities [N, *DIM, classes], or a dict of them per head
        (cmrtpu's ``Trainer.predict``)."""
        x = np.asarray(x, np.float32)
        self.model.eval()
        with torch.inference_mode():
            out = torch.func.functional_call(
                self.model, self.serving_params,
                (torch.as_tensor(x, device=self.device),))
        return to_numpy(out, x.shape[0])

    def evaluate(self, data: Iterable) -> Dict[str, float]:
        """Mean eval-step logs over host (x, y) batches (cmrtpu's
        ``Trainer.evaluate``)."""
        return self._run_epoch(data, training=False)

    # -- checkpoint / resume ----------------------------------------------
    def train_state(self) -> Dict:
        """The full train state, by reference (``ckpt.device_snapshot``
        copies it): weights and BatchNorm averages, the optimizer's rule and
        state (moments, count, learning rate), the step, the EMA shadow and
        the two draw generators' states."""
        return {"model": self.model.state_dict(),
                "optimizer_name": self.optimizer_name,
                "optimizer": self.optimizer.state_dict(),
                "step": self.state.step, "lr": self.get_lr(),
                "ema": self.state.ema,
                "generators": {"dropout": self.generator.get_state(),
                               "loop": self.loop_generator.get_state()}}

    def restore(self, ckpt_dir: str) -> int:
        """Full-state resume from ``ckpt_dir/state.pt``; returns the
        restored step count. A state saved after OptimizerChanger switched
        to sgd restores into sgd. FileNotFoundError when there is no state;
        a state of another model, rule layout or device kind raises."""
        saved = ckpt.restore_train_state(ckpt_dir)
        if saved["optimizer_name"] != self.optimizer_name:
            self.switch_optimizer(saved["optimizer_name"])
        self.model.load_state_dict(saved["model"])
        self.optimizer.load_state_dict(saved["optimizer"])  # lr, count too
        self.state.step = int(saved["step"])
        if (saved["ema"] is None) != (self.state.ema is None):
            raise ValueError(f"{ckpt_dir}: the saved state has "
                             f"{'no ' if saved['ema'] is None else ''}EMA "
                             "shadow, the config says otherwise")
        if saved["ema"] is not None:
            self.state.ema = {n: t.to(self.device)
                              for n, t in saved["ema"].items()}
        self.generator.set_state(saved["generators"]["dropout"])
        self.loop_generator.set_state(saved["generators"]["loop"])
        self._broadcast_state()
        return self.state.step

    def restore_weights(self, model_path: str) -> None:
        """Load a weights-only model.npz; with EMA on the shadow is seeded
        from the loaded weights, not kept at the initial ones."""
        ckpt.load_weights_for_model(model_path, self.model, self.config)
        if self.state.ema is not None:
            self.state.reset_ema()
        self._broadcast_state()

    def _fit_loop(self, train_epoch: Callable[[], Dict[str, float]],
                  eval_epoch: Optional[Callable[[], Dict[str, float]]],
                  epochs: Optional[int], callbacks: Optional[List[Callback]],
                  initial_epoch: int,
                  after_epoch: Optional[Callable[[], None]] = None
                  ) -> List[Dict[str, float]]:
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
                logs = self._logs_over_ranks(logs)
                logs["epoch_time"] = time.time() - t0
                self.history.append(logs)
                for cb in callbacks:
                    cb.on_epoch_end(self, epoch, logs)
                if after_epoch is not None:
                    after_epoch()
                logging.info("epoch %d/%d %s", epoch + 1, epochs,
                             " ".join(f"{k}={v:.4f}"
                                      for k, v in sorted(logs.items())))
                if self.mesh.distributed:
                    self.stop_training = M.any_rank(self.stop_training)
                if self.stop_training:
                    break
        finally:
            self._end_callbacks(callbacks)
        return self.history

    def _logs_over_ranks(self, logs: Dict[str, float]) -> Dict[str, float]:
        """The epoch's logs averaged over the ranks in float64 (exact where
        they agree already), so every callback decides alike everywhere."""
        if not self.mesh.distributed or not logs:
            return logs
        keys = sorted(logs)
        (mean,) = M.mean_over_ranks(
            [torch.tensor([logs[k] for k in keys], dtype=torch.float64,
                          device=self.device)], self.mesh, "epoch_logs_mean",
            dtype=torch.float64)
        return dict(zip(keys, mean.tolist()))

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

    def _run_epoch(self, data: Iterable, training: bool) -> Dict[str, float]:
        """Mean logs over the (x, y) batches of ``data`` (numpy or tensors,
        already finalized), moved to the card one at a time; each rank
        takes its rows (an eval batch the ranks do not divide is evaluated
        whole on every rank)."""
        logs = []
        for x, y in data:
            whole = not training and len(x) % self.mesh.data != 0
            if not whole:
                x, y = M.shard_batch((x, y), self.mesh)
            x = torch.as_tensor(x, device=self.device)
            y = torch.as_tensor(y, device=self.device)
            logs.append(self.state.train_step(x, y) if training
                        else self.state.eval_step(x, y, gather=not whole))
        if not logs:
            return {}
        keys = list(logs[0])
        means = torch.stack([torch.stack([s[k].float() for s in logs]).mean()
                             for k in keys]).tolist()
        return dict(zip(keys, means))

    def fit(self, train_data, val_data=None, epochs: Optional[int] = None,
            callbacks: Optional[List[Callback]] = None,
            initial_epoch: int = 0) -> List[Dict[str, float]]:
        """Train over host iterables of finalized (x, y) batches (cmrtpu's
        ``fit``); ``train_data.on_epoch_end()`` runs after each epoch where
        it exists, after the callbacks."""
        return self._fit_loop(
            lambda: self._run_epoch(train_data, training=True),
            (lambda: self._run_epoch(val_data, training=False))
            if val_data is not None else None,
            epochs, callbacks, initial_epoch,
            after_epoch=getattr(train_data, "on_epoch_end", None))

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

    def fit_streamed(self, train_gen, val_gen=None,
                     epochs: Optional[int] = None,
                     callbacks: Optional[List[Callback]] = None,
                     initial_epoch: int = 0) -> List[Dict[str, float]]:
        """Train from packed host-streamed batches (see
        cmrtpu_torch/train/streaming.py): the deterministic stage streams in
        its storage dtypes, the stochastic stage runs in the step on the
        card."""
        from cmrtpu_torch.train.streaming import StreamedLoop

        loop = StreamedLoop(self, train_gen, val_gen)
        return self._fit_loop(
            loop.run_train_epoch,
            loop.run_eval_epoch if val_gen is not None else None,
            epochs, callbacks, initial_epoch)
