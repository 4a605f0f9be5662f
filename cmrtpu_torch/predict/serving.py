"""Batch serving: a restore-once engine that streams CMR studies through a
fixed-batch forward on an explicit device and writes predictions back in the
original image geometry, with per-stage latency records and an idempotent
directory loop — counterpart of ``cmrtpu/predict/serving.py``.

The engine serves a live checkpoint (config + ``model.npz``), an exported
artifact (``predict/export.py``: no model code is imported) or a CV root's
folds as one vmapped ensemble (``predict/ensemble.py``). File names, the
``<stem>.done.json`` marker protocol and the latency-record keys are those of
the reference, so the two servers share worklists and outputs.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from cmrtpu_torch import config as C
from cmrtpu_torch.ops import resample as R
from cmrtpu_torch.predict.postprocess import undo_generator_steps
from cmrtpu_torch.utils.io_utils import ensure_dir
from cmrtpu_torch.utils.profiling import GLOBAL_TIMER, span
from cmrtpu_torch.io import MedicalImage, read_image, write_image
from cmrtpu_torch.predict.predictor import (Predictor, _head_outputs,
                                            cc_clean_fn,
                                            preprocess_model_input,
                                            resolve_device, to_numpy)


def _flat_pred_heads(cfg: Dict, preds):
    """[(suffix, pred_flat, label_values)] of serve-time predictions: the
    predict path's head contract (``_head_outputs``) without ground
    truth."""
    return [(suffix, pred_flat, label_values)
            for suffix, pred_flat, _gt, label_values
            in _head_outputs(cfg, preds, None)]

_IMAGE_EXTS = (".nii.gz", ".nii", ".nrrd")


def _stem(path: str) -> str:
    """Study identity: the basename with only the known image extension
    stripped (dotted names such as DICOM UIDs stay distinct)."""
    base = os.path.basename(path)
    for ext in _IMAGE_EXTS:
        if base.endswith(ext):
            return base[: -len(ext)]
    return os.path.splitext(base)[0]


class ServingEngine:
    """Restore-once inference engine over a serving artifact, a CV root or
    a trained fold's checkpoint.

    ``artifact_dir``: a ``cmrtpu_torch.cli.export`` output; its program
    runs without the model code, its embedded config (``config`` entries
    override it) drives preprocessing and heads, and its ``x_shape`` fixes
    the batch. ``ensemble_root``: every fold checkpoint of a timestamped
    experiment root served as ONE vmapped average-probability ensemble at
    ``BATCHSIZE``. ``config`` + ``model_path``: the live restore.
    ``device``: where the preprocessing, the forward and the CC filter
    run; ``'cuda'`` raises when CUDA is missing. ``warmup``: run the
    preprocessing of a study of DIM, the forward (and the CC filter) once
    at init, so the first study pays no set-up."""

    def __init__(self, artifact_dir: Optional[str] = None,
                 config: Optional[Dict] = None,
                 model_path: Optional[str] = None, warmup: bool = True,
                 ensemble_root: Optional[str] = None, device="cuda"):
        t0 = time.perf_counter()
        if artifact_dir and ensemble_root:
            raise ValueError("pass an artifact_dir OR an ensemble_root")
        self.device = resolve_device(device)
        if ensemble_root:
            from cmrtpu_torch.predict.ensemble import EnsemblePredictor
            ens = EnsemblePredictor.from_exp_root(ensemble_root, config,
                                                  device=self.device)
            self.config = ens.config
            self.batch = max(int(C.get(self.config, "BATCHSIZE", 8) or 8), 1)
            self._forward = ens._forward
            self.n_members = ens.n_members
        elif artifact_dir:
            from cmrtpu_torch.predict.export import (load_exported,
                                                     load_exported_weights)
            fn, meta = load_exported(artifact_dir, device=self.device)
            self.config = C.normalise_config(dict(meta["config"],
                                                  **(config or {})))
            weights = load_exported_weights(artifact_dir, device=self.device)
            self.batch = int(meta["x_shape"][0])

            @torch.inference_mode()
            def forward(x):
                return fn(weights, torch.as_tensor(x, device=self.device))

            self._forward = forward
        else:
            if config is None:
                raise ValueError("need an artifact_dir, an ensemble_root or "
                                 "a config")
            predictor = Predictor(config, model_path, device=self.device)
            self.config = predictor.config
            self.batch = max(int(C.get(self.config, "BATCHSIZE", 8) or 8), 1)
            self._forward = predictor._forward
        self._dim = tuple(C.get(self.config, "DIM"))
        self._cc = cc_clean_fn(self.config)
        if warmup:
            preprocess_model_input(
                np.zeros((1, *self._dim), np.int16),
                tuple(reversed(C.get(self.config, "SPACING"))), self.config,
                device=self.device).cpu()
            x = np.zeros((self.batch, *self._dim,
                          int(C.get(self.config, "IMG_CHANNELS", 1))),
                         np.float32)
            to_numpy(self._forward(x), self.batch)
            if self._cc is not None:  # builds and loads the CUDA kernel
                self._cc(np.zeros((1, *self._dim)), (1,),
                         device=self.device).cpu()
        self.init_s = time.perf_counter() - t0
        self._totals = {"studies": 0, "slices": 0, "total_s": 0.0}
        logging.info("serving engine ready in %.1fs (batch=%d, device=%s, "
                     "source=%s)", self.init_s, self.batch, self.device,
                     artifact_dir or ensemble_root or model_path or "config")

    def predict_slices(self, x):
        """Forward a [N, H, W, C] batch (a tensor on the engine's device,
        as ``preprocess_model_input`` makes it, or an array, uploaded once)
        in ``self.batch``-row chunks, the last zero-padded on the device.
        Chunk outputs stay on the device until the last one is queued; one
        copy brings them back (one per head for a HEADS model, which
        returns a dict). Counts the real rows (``serve.rows_real``) and the
        rows forwarded with the padding (``serve.rows_forwarded``) in
        ``GLOBAL_TIMER``."""
        x = torch.as_tensor(x, device=self.device)
        n = x.shape[0]
        outs: List[torch.Tensor] = []
        for start in range(0, n, self.batch):
            chunk = x[start:start + self.batch]
            pad = self.batch - chunk.shape[0]
            if pad:
                chunk = torch.cat(
                    [chunk, chunk.new_zeros((pad, *x.shape[1:]))])
            outs.append(self._forward(chunk))
        GLOBAL_TIMER.count("serve.rows_real", n)
        GLOBAL_TIMER.count("serve.rows_forwarded", len(outs) * self.batch)
        if isinstance(outs[0], dict):
            return to_numpy({k: torch.cat([o[k] for o in outs])
                             for k in outs[0]}, n)
        return to_numpy(torch.cat(outs), n)

    def process_study(self, path: str, out_dir: str) -> Dict:
        """One study end-to-end: read -> preprocess on the engine's device
        -> forward -> threshold (+ optional CC filter) ->
        inverse-preprocess -> write ``<stem>_msk_pred.nrrd`` (and
        ``<stem>_<name>_pred.nrrd`` per further head). Returns the latency
        record, whose times are the spans' own: ``serve.study``
        (``total_s``) over ``serve.read``, ``serve.preprocess``,
        ``serve.forward`` and ``serve.cc`` + ``serve.undo`` +
        ``serve.write`` (``post_write_s``). Counts the rows preprocessed on
        a CUDA device (``serve.rows_preprocessed_device``, 0 elsewhere) in
        ``GLOBAL_TIMER``."""
        stem = _stem(path)
        stats: Dict = {"file": os.path.basename(path)}
        with span("serve.study", stem=stem) as study:
            with span("serve.read") as read:
                img = read_image(path)
                nda = img.array
                squeeze_2d = nda.ndim == 2
                if squeeze_2d:  # single slice -> z-stack of one
                    nda = nda[None]
                if nda.ndim != 3:
                    raise ValueError(
                        f"{path}: serving handles 2D/3D studies, got shape "
                        f"{nda.shape}")

            with span("serve.preprocess") as prep:
                x = preprocess_model_input(nda, img.spacing[:2], self.config,
                                           device=self.device)
                GLOBAL_TIMER.count("serve.rows_preprocessed_device",
                                   x.shape[0] if x.is_cuda else 0)

            with span("serve.forward") as fwd:
                preds = self.predict_slices(x)

            with span("serve.cc") as cc:  # threshold, K2 and its copy back
                heads = []
                for suffix, flat, label_values in _flat_pred_heads(
                        self.config, preds):
                    if self._cc is not None:
                        flat = self._cc(flat, label_values,
                                        device=self.device).cpu().numpy()
                    heads.append((suffix, flat))

            with span("serve.undo") as undo:
                if squeeze_2d:
                    # a single slice becomes a z-stack of one with the
                    # reference's 10 mm config-spacing fallback
                    orig = MedicalImage(
                        array=nda, spacing=tuple(img.spacing[:2]) + (10.0,),
                        origin=tuple(img.origin[:2]) + (0.0,),
                        metadata=dict(img.metadata))
                else:
                    orig = MedicalImage(array=nda, spacing=img.spacing,
                                        origin=img.origin,
                                        direction=img.direction,
                                        metadata=dict(img.metadata))
                images = []
                for suffix, flat in heads:
                    out_img = undo_generator_steps(flat.astype(np.uint8),
                                                   self.config, R.NEAREST,
                                                   orig)
                    if squeeze_2d:
                        out_img = MedicalImage(
                            array=out_img.array[0],
                            spacing=out_img.spacing[:2],
                            origin=out_img.origin[:2],
                            metadata=dict(out_img.metadata))
                    images.append((f"{stem}_{suffix}_pred.nrrd", out_img))

            with span("serve.write") as write:
                for name, out_img in images:
                    write_image(out_img, os.path.join(out_dir, name))

        stats["read_s"] = round(read.seconds, 4)
        stats["preprocess_s"] = round(prep.seconds, 4)
        stats["forward_s"] = round(fwd.seconds, 4)
        stats["post_write_s"] = round(
            cc.seconds + undo.seconds + write.seconds, 4)
        stats["slices"] = int(x.shape[0])
        stats["outputs"] = [name for name, _ in images]
        stats["total_s"] = round(study.seconds, 4)
        stats["slices_per_s"] = round(stats["slices"] / stats["total_s"], 1)
        self._totals["studies"] += 1
        self._totals["slices"] += stats["slices"]
        self._totals["total_s"] += stats["total_s"]
        return stats

    def totals(self) -> Dict:
        t = dict(self._totals)
        t["slices_per_s"] = round(t["slices"] / t["total_s"], 1) \
            if t["total_s"] else 0.0
        return t


DEFAULT_PATTERNS = ("*.nii.gz", "*.nii", "*.nrrd")
# label-valued files that must never be treated as image studies: serving
# outputs, pred_fold's mask families, and dataset/RVIP ground truth
LABEL_SUFFIXES = ("_pred.nrrd", "_msk.nrrd", "_seg.nrrd", "_rvip.nrrd")
# plus pred_fold's original-geometry CMR copies
DEFAULT_EXCLUDE = LABEL_SUFFIXES + ("_cmr.nrrd",)


_warned_collisions: set = set()  # (loser, winner) stem collisions already
# warned about; pairs that leave their directory's scan are pruned


def _worklist(in_dir: str, patterns: Sequence[str],
              exclude: Sequence[str] = DEFAULT_EXCLUDE) -> List[str]:
    files: List[str] = []
    for pat in patterns:
        files.extend(glob.glob(os.path.join(in_dir, pat)))
    # never re-ingest our own outputs when in_dir == out_dir
    out = sorted(f for f in set(files) if not f.endswith(tuple(exclude)))
    # one study identity per stem: serve the (sorted) first, warn about the
    # rest, which would otherwise share its marker and output names
    seen: Dict[str, str] = {}
    unique: List[str] = []
    current: set = set()
    for f in out:
        stem = _stem(f)
        if stem in seen:
            pair = (f, seen[stem])
            current.add(pair)
            if pair not in _warned_collisions:
                logging.warning(
                    "serve worklist: %s collides with %s on study stem '%s'"
                    " — only the first is served; rename one of them to "
                    "serve both", f, seen[stem], stem)
            continue
        seen[stem] = f
        unique.append(f)
    prefix = os.path.join(in_dir, "")
    _warned_collisions.difference_update(
        p for p in tuple(_warned_collisions)
        if p[0].startswith(prefix) and p not in current)
    _warned_collisions.update(current)
    return unique


def _claim(marker: str, stale_claim_s: float) -> Optional[int]:
    """Atomically claim a study. Returns an open fd, or None if the study
    is already served/claimed. An EMPTY marker older than ``stale_claim_s``
    is a dead claim and is taken over by a rename, which exactly one of N
    competing reclaimers wins."""
    try:
        return os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        try:
            st = os.stat(marker)
            if st.st_size == 0 and time.time() - st.st_mtime > stale_claim_s:
                grave = f"{marker}.stale.{os.getpid()}"
                os.rename(marker, grave)  # atomic: one winner, losers raise
                os.unlink(grave)
                logging.warning("reclaimed stale empty claim %s (a previous "
                                "server died mid-study)", marker)
                return os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except OSError:
            pass
        return None


def _heartbeat(marker: str, interval_s: float):
    """Background mtime touch while a study is processed, so a long study is
    never mistaken for a dead claim. Returns a stop callable."""
    import threading

    stop = threading.Event()

    def _touch():
        while not stop.wait(interval_s):
            try:
                os.utime(marker)
            except OSError:  # marker released (interrupt path) — stop
                return

    t = threading.Thread(target=_touch, daemon=True,
                         name="cmrtpu-claim-heartbeat")
    t.start()

    def _stop():
        stop.set()
        t.join(timeout=interval_s + 1.0)

    return _stop


def serve_directory(engine: ServingEngine, in_dir: str, out_dir: str,
                    patterns: Sequence[str] = DEFAULT_PATTERNS,
                    watch: bool = False, poll_s: float = 2.0,
                    settle_s: float = 1.0, stale_claim_s: float = 900.0,
                    stats_path: Optional[str] = None,
                    max_studies: Optional[int] = None,
                    stop_after_idle_polls: Optional[int] = None) -> Dict:
    """Process every matching study in ``in_dir`` exactly once.

    A study is claimed by atomically creating ``<stem>.done.json`` in
    ``out_dir`` before processing; the marker is filled with the latency
    record after. An interrupt mid-study removes its own claim; a hard-killed
    server leaves an empty marker, reclaimed once older than
    ``stale_claim_s``. Files modified less than ``settle_s`` ago are
    deferred. ``watch=True`` keeps polling every ``poll_s``;
    ``stop_after_idle_polls`` bounds watch mode; ``max_studies`` bounds the
    studies attempted by this call. Returns the aggregate record."""
    ensure_dir(out_dir)
    stats_fh = open(stats_path, "a") if stats_path else None
    idle_polls = 0
    attempted = 0
    try:
        while True:
            did_work = False
            deferred = 0
            for path in _worklist(in_dir, patterns):
                if max_studies and attempted >= max_studies:
                    break
                marker = os.path.join(out_dir, f"{_stem(path)}.done.json")
                try:
                    if time.time() - os.path.getmtime(path) < settle_s:
                        deferred += 1
                        continue  # still being written — defer
                except OSError:
                    continue  # vanished between glob and stat
                fd = _claim(marker, stale_claim_s)
                if fd is None:
                    continue  # processed (or live-claimed) already
                stop_heartbeat = _heartbeat(marker,
                                            max(stale_claim_s / 4.0, 0.5))
                with os.fdopen(fd, "w") as fh:
                    try:
                        record = engine.process_study(path, out_dir)
                    except Exception as e:
                        record = {"file": os.path.basename(path),
                                  "error": f"{type(e).__name__}: {e}"}
                        logging.exception("serving failed on %s", path)
                    except BaseException:
                        # interrupt mid-study: release the claim so a
                        # restart re-serves this study
                        os.unlink(marker)
                        raise
                    finally:
                        stop_heartbeat()
                    json.dump(record, fh)
                attempted += 1
                if stats_fh:
                    stats_fh.write(json.dumps(record) + "\n")
                    stats_fh.flush()
                did_work = True
                logging.info("served %s: %s", path,
                             record.get("slices_per_s", record.get("error")))
            if max_studies and attempted >= max_studies:
                break
            if not watch:
                if deferred:
                    logging.warning(
                        "serve_directory: %d file(s) modified < %.1fs ago "
                        "were deferred as possibly half-written and left "
                        "unclaimed — re-run (or use --watch) to serve them",
                        deferred, settle_s)
                break
            idle_polls = 0 if did_work else idle_polls + 1
            if stop_after_idle_polls and idle_polls >= stop_after_idle_polls:
                break
            time.sleep(poll_s)
    finally:
        if stats_fh:
            stats_fh.close()
    totals = engine.totals()
    logging.info("serve_directory done: %s", totals)
    return totals
