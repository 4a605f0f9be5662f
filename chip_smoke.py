#!/usr/bin/env python3
"""Smoke run of cmrtpu_torch on one CUDA card (an H100 for sm_90a).

    python3 chip_smoke.py
    python3 chip_smoke.py --cards N   # N cards of one host (cards_main)

Run from the root of a checkout. ``--cards N`` runs only the multi-process
check over N cards (``cards_main``); without it, one card and these
phases, one line each:
  1. device    — require CUDA; print the card's name and power limit;
  2. build     — one nvcc build of every kernel (csrc/*.cu, one process per
                 source), print ptxas's report for each;
  2a. k1-3d    — K1 at the 3D path's [B * C * T, H, W] = [128, 224, 224]
                 (sigma 2), as phase 4 checks and times it;
  2b. cc3d     — the 3D CC kernel (csrc/cc_labels_3d.cu) against its plain
                 version on the card and scipy's 26-connected labels,
                 exactly, on stacks of [10, 224, 224] studies (landmark-like
                 balls across slices, density 0.55, voxels that touch only
                 across a corner, empty and full, corner-only chains
                 through every tile corner), the longest geodesic at
                 [5, 96, 96], [20, 200, 190] at density 0.3 (two tiles
                 deep, ragged width), corner chains at [19, 203, 190]
                 (ragged every way) and [1, 224, 224] at density 0.55; two
                 launches bit-identical; kept volumes equal to scipy's;
                 timed by events, a CUDA graph and the profiler by pass,
                 beside the plain version and the bound;
  3. k2        — the CC-label kernel against its plain torch version on the
                 card and scipy's labels, exact, at [10, 224, 224] (random
                 0.3/0.55/0.7, serpentine, empty/full/single), at the serving
                 path's stacked [20, 224, 224] (landmark-like discs) and at
                 [4, 512, 512]; a second launch must give the same labels
                 bit for bit (the atomics run in another order); timed by
                 CUDA events around wrapper calls and around a CUDA graph
                 of launches, and by the profiler's device time per pass;
  4. k1        — the Gaussian-blur kernel against its plain torch version on
                 the card and scipy (float64, host), atol 1e-5, at the
                 training path's [32, 224, 224], the prediction path's
                 [20, 224, 224] of landmark channels, edge cases, radii
                 outside the kernel's constants and a width that needs
                 column chunks; timed with L2 warm and flushed, beside the
                 plain version, a cuDNN yardstick and its bound;
  5. forward   — the flagship U-Net (exp/template_cfgs/gaus_sigma2_config.json)
                 with seeded random weights at batch 16, bf16 on the card,
                 against the port's f32 forward on the CPU;
  6. serve     — a fold with those weights serves 3 synthetic studies through
                 the cmrtpu_torch.cli.serve entry point; K2's launch counter
                 must show one launch per study and one for the engine's
                 warm-up;
  7. train     — the full_cv_demo tool's phantom cohort (8 patients,
                 10 slices) is sliced by the cmrtpu_torch.cli.make_dataset
                 entry point; the flagship config (EPOCHS 2) trains fold 0
                 through cmrtpu_torch.cli.train, which chains pred_fold. K1
                 must launch exactly once per sample batch (train_fold
                 finalizes batch 0 of the train and of the val generator
                 for the ImageWriter first, whatever the SAVE flags say),
                 train and eval step and once per patient-phase of
                 pred_fold, K2 exactly once per patient-phase; pred/, gt/
                 and _cmr files must stand in the cohort's geometry, and
                 the model.npz must serve; the ImageWriter the template
                 asks for warns once, naming matplotlib, and runs no
                 forward where matplotlib is missing (it draws epoch 0's
                 two batches where it is not); then warm train steps are
                 timed (CUDA events) and profiled; one line of the host
                 stage (the generators' builds and GLOBAL_TIMER's
                 generator/fix_preprocess and generator/batch stages)
                 beside the fold's wall s; profile — three warm steps
                 under profiling.trace: the Chrome trace holds the step's
                 own train.step span three times and K1's kernel;
  8. predict   — cmrtpu_torch.cli.predict on the fold rewrites every output
                 with exactly one launch of each kernel per patient-phase;
  9. evaluate  — cmrtpu_torch.cli.evaluate_cv writes df_eval.csv: one row
                 per patient-phase, all four sources' columns, finite
                 prediction distances; then one line of the chained
                 pred_fold's and the CLIs' wall times and stage ms;
 10. train-f32 — one f32 train step at flagship width on the card and on the
                 CPU from the same weights and batch, against a float64 CPU
                 evaluation of the same step;
 11. train-f32-bn — the same for example_config.json with ELU (BatchNorm
                 in train mode): gradients and the running averages it
                 moves;
 12. histmatch — the binned histogram matcher (Var.1) on the card against
                 its CPU version on the same [16, 224, 224] slices: equal
                 bin indices, values within 1e-6;
 13. forward-transpose — the flagship with the transpose-conv decoder
                 (USE_UPSAMPLE false), bf16 on the card against f32 on the
                 CPU, within bounds tighter than phase 5's (this net
                 rounds less, and its controls must fail them too);
 14. variants  — one phantom cohort with per-slice _seg targets; each of
                 example (Base), gaus_sigma4 (Var.3), histmatch (Var.1)
                 and multihead at its own widths, EPOCHS 2 and FOLDS [0],
                 through cli.train (chained pred_fold) and cli.evaluate_cv,
                 with exact launch counts (K1: none for Base and Var.1, one
                 per sample batch, train and eval step and patient-phase
                 otherwise; K2:
                 one per patient-phase and head); one line per template of
                 warm step ms beside the flagship's GroupNorm step, the
                 matcher's ms per step (Var.1), pred_fold ms per
                 patient-phase, evaluate_cv s and the seg-dice columns;
 15. serve-multihead — the multihead fold serves 3 studies through
                 cli.serve: _msk and _seg per study, K2 twice per study and
                 once for the warm-up;
 16. resume    — on a new phantom cohort, the flagship through cli.train
                 with EPOCHS 2, then cli.train -resume <run> with EPOCHS 4:
                 the restored state bit-equal to the one saved at the best
                 epoch, history.csv's earlier rows byte-equal, epochs 0-3,
                 fold_complete.json targeting 4, K1 once per sample batch
                 (drawn before the restore), train and eval step retrained
                 and per patient-phase, K2 4; a third call
                 skips the fold (no launch, no file changed); the ms of a
                 full-state save, synchronous and as the async submit;
 17. resume-exact — float32, SHUFFLE false, augmentation and dropout on:
                 3 epochs straight against 2 then resumed to 3, within a
                 bound measured on the card, which a control resumed
                 without its generators' states must fail;
 18. ema       — a 2-epoch fold with EMA true: model.npz holds the shadow,
                 the chained pred_fold runs from it (K1 and K2 once per
                 patient-phase); the step with and without EMA;
 19. cache-dtype — the loop from float32, bfloat16 and uint8 image caches:
                 the bytes on the card, one epoch's loss within a bound of
                 float32's, the step;
 20. optimizers — the 7 rules and adam with AGC 0.08: 3 f32 steps at
                 batch 2 on the card and the CPU (the card's rule on the
                 CPU's gradients, and whole steps), each within a stated
                 bound relative to the change; the bf16 step at batch 16;
 21. forward-3d, forward-3d-transpose — cine_3d_config.json's U-Net at its
                 published widths (DIM [8, 224, 224], depth 4, 32 filters,
                 BatchNorm with running averages from one batch) at batch
                 2, bf16 and f32 (TF32 off) on the card against float64 on
                 the card, with both decoders; controls that skip a norm
                 must fall outside the bf16 bounds;
 22. forward-hybrid — each MODEL_VARIANT of that template (wrapper,
                 followed, concat, avg, avg_plain, unet_2p1d) and the
                 template with deep supervision, at its widths, batch 2,
                 BatchNorm averages from one batch: bf16 on the card
                 against float64 on the card within each case's bounds,
                 which its controls (a skipped norm per trunk, z folded in
                 the wrong order, a (2+1)D block without its middle
                 activation, no supervision gate, no head_avg) must fail;
                 softmax outputs sum to 1; the wrapper equals its 2D trunk
                 slice by slice;
 23. train-3d  — that template at its widths, EPOCHS 2, through
                 DataGenerator + Trainer.fit_cached on 24 + 8 cine volumes
                 of the ported cine demo: K1 exactly once per train and
                 eval step; Trainer.predict on the validation volumes equal
                 to the restored Predictor's; warm steps timed (median of
                 12) and profiled, frames/s and the peak memory;
 24. train-hybrid — the same for MODEL_VARIANT wrapper, avg and unet_2p1d
                 on the same cohort; then followed and concat one warm and
                 one timed step each, K1 once a step;
 25. skip-list — on the same cohort: remat (the template as shipped, one
                 step at REMAT 0, 1, 2 and true from one set of weights,
                 one augmented batch and one dropout generator state, cuDNN
                 deterministic: equal losses and running averages,
                 gradients within REMAT_GRAD_BOUND of REMAT 0's, peak
                 memory and step ms each; controls: a wrap without the
                 generator replay breaks the bound, one that moves the
                 averages in the recompute breaks their equality); bn-bf16
                 (example_config's widths at batch 16 with BN_BF16: the
                 eval forward, one step's gradients and running averages
                 against float64 within BN_BF16_FACTOR of the f32
                 BatchNorm net's distance, the loss within
                 BN_BF16_LOSS_RTOL, peak memory beside f32 BatchNorm's);
                 probes (cmrtpu_torch.tools.roofline --steps 5, probe2d
                 --base --set GROUP_NORM=16, probe3d --only
                 base,remat1,remat_full,bn_bf16 --steps 3 --warmup 2: no
                 row with an error, every share of the H100's peaks at
                 most 1). train-3d now runs the template's REMAT true and
                 logs the REMAT 0 step beside it.
Inside phase 16's cohort, after cache-dtype: supervision — the flagship
through Trainer(cfg, supervision=True).fit_cached for one epoch, K1 once
per train and eval step, the model.npz restored through Predictor with its
branch and equal to Trainer.predict; then surface — a model composed of
ConvEncoder and ConvDecoder at the flagship's widths (GroupNorm in both
halves, a 1x1 float32 head) held in bf16 at batch 16 against its float64
evaluation on the card within phase 5's bounds (controls with a
GroupNorm skipped must fail them) and equal to the flagship U-Net on the
same weights, trained one epoch through Trainer(cfg, model=...)
.fit_cached (K1 once per train and eval step), its model.npz read back to
equal outputs and its warm step timed against the flagship U-Net's in
interleaved rounds; largest_component_2d on every
slice of the k2 phase's cases (K2 once each) equal to
largest_component_batch and the host filter; the host filters
(clean_3d_prediction_{2d,3d}_cc_host) equal to the card's K2 and 3D-kernel
filters on the k2 and cc3d phases' cases, full slices and volumes
included; show_available_devices naming the card; then slice 6's
sharded-cache —
sharded_cache_config.json at its widths (EPOCHS 2) through cli.train
(chained pred_fold) and cli.evaluate_cv: K1 once per sample batch, train
step, eval batch (the tail's too) and patient-phase, K2 once per
patient-phase;
every gradient the rule reads bf16-representable (the control without
GRAD_ALLREDUCE_DTYPE not); with CACHE_RESHUFFLE_EPOCHS 1 the caches on the
card equal the host caches permuted by the loop rng's draws, byte for byte;
the warm step beside the flagship's; and stream — the flagship through
cli.train -inmemory false (the streamed loop): K1 twice for the sample
batches, (7 + 2) times an epoch and once per patient-phase, K2 once per
patient-phase; in process one streamed
epoch against one device-cached epoch from the same weights and draws
within STREAM_PARITY_RTOL (a control with one batch perturbed outside it);
STREAM_ECHO 2 two steps per upload with differing draws; pinned staging
and a side copy stream; at STREAM_ECHO 1 and 2, from the host cache and
without it: streamed against cached step ms, bytes and copy ms per batch,
producer ms, the step's wait for its copy and the idle share; then the
last slice's distributed — a process group over NCCL at world size 1 in
this process: sharded_cache_config.json at its widths (EPOCHS 2) through
cli.train (chained pred_fold) with K1 and K2 launched as in sharded-cache
and one model.npz; one global-view step (the flagship) and one
explicit-collectives step (the sharded template) against the plain
one-card step from the same weights, rows and draws (|Δloss|, the
gradients' relative difference and the share of weights that moved
differently within bounds that two plain steps meet and a step on other
rows exceeds tenfold; max |Δparam| logged), each step's collectives as
tests/test_torch_multiprocess.py lists them, the warm step ms against the
plain step's in interleaved rounds; the group is left, then one
``python -m torch.distributed.run --standalone --nproc_per_node 1 -m
cmrtpu_torch.cli.train`` at EPOCHS 1 must exit 0 and leave the fold's
files.
Inside phase 7, after evaluate: cc3d-cli — a copy of the flagship fold
with CC_FILTER '3d' through cli.predict and cli.serve: the 3D kernel once
per patient-phase, study and warm-up, K2 never, each cleaned volume equal
to scipy's 26-connected filter of the same thresholded predictions and each
written label file that filter's output in the written geometry; then
predict-4d — each of fold 0's two test patients gets an ACDC-sized cine
(30 frames x 10 slices of 200^2, its ED and ES volumes swept over one
cycle) and cli.predict_4d runs the trained fold over them: K2 exactly once
per cine (both labels of all 300 slices stacked), K1 and the 3D kernel
never; each [30, 10, 224, 224] uint8 volume equal to scipy's per-slice
filter of the same forward thresholded on the host, and a control with
one frame's filter skipped unequal; K2 at the stacked [600, 224, 224]
exact against plain and scipy and timed; wall s, stage ms, the forward's
slices/s and the process's peak memory during the call beside what it
held at the call's start; predict-4d-3d — the same on a copy of the fold
with CC_FILTER '3d' (the 3D kernel once per cine, K2 never, scipy's
26-connected filter per frame; the 3D kernel at the stacked [60, 10, 224,
224] exact against plain and scipy and timed, and the cine's cc_ms beside
the kernel's and _keep_largest's device us there); override-twin —
predict_override_twin(exp, CC_FILTER '3d') on the card: K1 and the 3D
kernel once per patient-phase, K2 never, every twin pred/ file byte-equal
to the cc3d-cli copy's, and evaluate_cv_save on the plain and the twin
root one row per patient-phase with finite distances. Then slice 5's
serving extras on the same fold, at batch 16: tta — TTA 'probs' and
'coords' against a float64 recomputation from the four per-rotation
forwards (a control that does not rotate back must fail), forward ms
beside the plain forward, cli.serve of each (K2 once per study and the
warm-up) and predict_tta_twin of each through pred_fold and
cli.evaluate_cv; ensemble — the fold and three seeded-noise copies as a
CV root: the vmapped float32 ensemble against its members' mean (a
control without a member must fail), the batched bf16 forward's ms
against four sequential ones, cli.serve -ensemble, soup_experiment and
cli.evaluate_cv of the soup root; export — cli.export, cli.serve
-artifact in a fresh interpreter that imports no cmrtpu_torch.models
(its K2 launches counted there), labels equal to the live fold's, a
swapped weights.npz that must change the output, --fold-bn of a BN_FIRST
copy against the unfolded model and served; int8 — the int8 conv bit for
bit against its float64 plain version at [16, 32, 224, 224] and [1, 32,
8, 224, 224], quantize_fold on the fold's training slices, pred_fold and
cli.evaluate_cv of the twin, its |delta prob| against the float fold,
cli.export --int8 served through -artifact, forward ms int8 against bf16.
Then slice 7's ab-tools on the same experiment, each tool's main(argv)
with --device cuda: predict_ab --set CC_FILTER=3d (K1 and the 3D kernel
once per patient-phase), tta_ab --mode coords and int8_ab --calib-studies
4 (K1 and K2 once per patient-phase), and soup_ab on a 4-member CV root of
the fold and its noisy copies whose test splits are predicted first; each
path's launches exact and each printed mean equal to the mean read back
from the two df_eval.csv files the tool names; then the skip-list phase's
ws — the flagship with WEIGHT_STANDARDISATION and WS_I_UNDERSTAND through
cli.train (EPOCHS 2, chained pred_fold) on the same cohort: K1 once per
sample batch, step and patient-phase, K2 once per patient-phase, WSConv_0
weights and no norm; its int8 twins without and with bias correction
served through cli.serve (K2 once per study and the warm-up), their max
and mean |delta prob| against the float fold at batch 16. After phase 7: quickstart —
the port's synthetic quickstart (--epochs 3 --patients 4 --tta --int8) on
the card with exact launches, then analyze_results, its summary.csv held
against numpy's statistics of the df_eval.csv.
Then one JSON line of kernel figures (launches by path: serve, train,
pred_fold, predict_cli, the variants' and multihead serving's paths, the
resume, resume-exact and ema phases' runs, supervision, surface, the
sharded, streamed and distributed CLI runs, train_3d, the
train-hybrid runs, the skip-list phase's remat batch, WS fold and its
served twins, predict_cli_3d and serve_3d with CC_FILTER '3d',
predict_4d, predict_4d_3d, override_twin, the serving extras' paths, the
A/B tools' and the quickstart's),
the card's name and power limit, and, last, the result line
``{"ok": true, "device": {...}}``. Any failed check raises,
which exits non-zero without a result line; so does a host without CUDA.
Imports nothing of JAX and nothing of cmrtpu.
"""

import contextlib
import copy
import csv
import glob
import importlib.util
import io
import types
import warnings
import zipfile
import json
import logging
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import scipy.ndimage
import torch
import torch.nn.functional as F

from cmrtpu_torch.cli.evaluate_cv import main as evaluate_main
from cmrtpu_torch.config import normalise_config
from cmrtpu_torch.cli.make_dataset import cli as make_dataset_main
from cmrtpu_torch.cli.predict import main as predict_main
from cmrtpu_torch.cli.predict_4d import main as predict_4d_main
from cmrtpu_torch.cli.serve import main as serve_main
from cmrtpu_torch.cli.train import main as train_main
from cmrtpu_torch.data.dataset import fold_patients, get_trainings_files
from cmrtpu_torch.eval.evaluate import evaluate_cv_save
from cmrtpu_torch.io import MedicalImage, read_image, write_image
from cmrtpu_torch.models import unet as unet_module
from cmrtpu_torch.models.hybrids import HYBRIDS, get_model
from cmrtpu_torch.models.unet import (BatchNorm, ConvDecoder, ConvEncoder,
                                      build_model, dropout_schedule,
                                      wide_dtype)
from cmrtpu_torch.ops import connected_components as cc
from cmrtpu_torch.ops import cuda_kernels as kernels
from cmrtpu_torch.ops.gaussian import (gaussian_blur_2d, gaussian_kernel1d,
                                       symmetric_index)
from cmrtpu_torch.pipeline.augment import apply_params, draw_params
from cmrtpu_torch.pipeline.generator import (DataGenerator, finalize_batch,
                                             normalise_batch)
from cmrtpu_torch.pipeline.histmatch import _binned_cdf, \
    match_histograms_binned
from cmrtpu_torch.ops.resample import NEAREST
from cmrtpu_torch.parallel import mesh as dist_mesh
from cmrtpu_torch.predict import predictor as predictor_module
from cmrtpu_torch.predict.postprocess import undo_generator_steps
from cmrtpu_torch.predict.predictor import (TIMING_LOG, Predictor,
                                            pred_fold, predict_override_twin,
                                            preprocess_model_input)
from cmrtpu_torch.predict.ensemble import EnsemblePredictor, soup_experiment
from cmrtpu_torch.predict.export import load_exported, load_exported_weights
from cmrtpu_torch.predict.quantize import (
    calibration_batches_from_studies, quantize_fold, quantize_model)
from cmrtpu_torch.predict.tta import (predict_tta_twin,
                                      tta_rot90_coords_forward)
from cmrtpu_torch.cli.export import main as export_main
from cmrtpu_torch.tools import (analyze_results, int8_ab, predict_ab,
                                soup_ab, synthetic_quickstart, tta_ab)
from cmrtpu_torch.tools.cine_quality_demo import generate_cine_cohort
from cmrtpu_torch.tools.full_cv_demo import _write_seg_slices, generate_cohort
from cmrtpu_torch.train.checkpoint import (_flatten, _unflatten,
                                           flax_to_state_dict, load_weights,
                                           save_weights)
from cmrtpu_torch.train import callbacks as train_callbacks
from cmrtpu_torch.train import device_cache
from cmrtpu_torch.train.device_cache import DeviceCachedLoop
from cmrtpu_torch.train.losses import get_loss
from cmrtpu_torch.train.optimizers import get_optimizer
from cmrtpu_torch.train.steps import TrainState
from cmrtpu_torch.train.streaming import StreamedLoop
from cmrtpu_torch.train.trainer import Trainer, init_model
from cmrtpu_torch.utils import profiling
from cmrtpu_torch.utils.io_utils import show_available_devices

SEED = 0
TEMPLATES = os.path.join("exp", "template_cfgs")
FLAGSHIP = os.path.join(TEMPLATES, "gaus_sigma2_config.json")
# the variants phase: template -> (K1 on its train and pred_fold paths,
# heads per patient-phase for K2)
VARIANTS = {"example_config.json": (False, 1),
            "gaus_sigma4_config.json": (True, 1),
            "histmatch_config.json": (False, 1),
            "multihead_config.json": (True, 2)}
# histmatch: the card's binned matcher against the CPU's, same inputs
HIST_ATOL = 1e-6
Z, H, W = 10, 224, 224
# the train phase's cohort (cmrtpu_torch/tools/full_cv_demo.py defaults)
COHORT_PATIENTS, COHORT_HW, COHORT_SPACING = 8, 200, (1.37, 1.37, 8.0)
INF = 2 ** 30
# card f32 (TF32 off) against CPU f32: the same math summed in another
# order, so a tight bound on probabilities
F32_ATOL = 1e-3
# card bf16 against CPU f32: bf16 keeps ~3 significant digits through 19
# conv + GroupNorm layers. On the CPU at 32^2 the reference's own bf16 output
# lies up to 0.17 from its f32 output. Measured on an H100 (700 W): max
# 0.149, mean 0.0131. A bf16 forward passes only if it is within both bounds;
# the control forwards below (a constant 0.5 output, and the net with one
# GroupNorm skipped) must each fail one of them, or the run fails. Measured
# on an H100 (700 W), the controls lie at max 0.385 and mean 0.095 or more
BF16_MAX_ATOL, BF16_MEAN_ATOL = 0.25, 0.025
# the transpose-conv flagship (forward-transpose) rounds less: measured on an
# H100 (700 W) max 0.045, mean 0.0043 (PERF.md), where the control
# without the bottleneck's GroupNorm lay at max 0.224, mean 0.019, inside
# the bounds above. Its own bounds keep ~2x over its bf16 error and leave
# every control outside
BF16_T_MAX_ATOL, BF16_T_MEAN_ATOL = 0.1, 0.01
# K1 against its plain version and scipy: the same float32 taps summed in
# another order (the kernel blurs along H first, the plain version along W)
K1_ATOL = 1e-5
# published H100 SXM peaks (700 W): HBM bytes/s and float32 FLOP/s outside
# the tensor cores
HBM_BYTES_S, F32_FLOP_S = 3.35e12, 67e12
# a write of this many bytes between launches evicts the 50 MB L2
FLUSH_BYTES = 64 << 20
# K2's three passes, as the profiler names their kernels
K2_KERNELS = ("cc_local_kernel", "cc_merge_kernel", "cc_flatten_kernel")
# train-f32: the f32 loss on the card against the CPU's
LOSS_RTOL = 1e-4
# train-f32: per parameter, the card's f32 gradient may lie at most this much
# (x max |g|) further from the float64 gradient than the CPU's f32 gradient
# does. A direct card-vs-CPU bound cannot work: at a random init the f32
# gradient of this GroupNorm U-Net lies up to ~1% of max |g| from float64 on
# any device (PERF.md), so two f32 gradients differ by as much
GRAD_EXTRA = 1e-3
# train-f32-bn: the card's f32 gradient of the BatchNorm (ELU) U-Net against
# float64, x max |g| per parameter. The batch statistics' backward makes it
# worse conditioned than GroupNorm's: measured on an H100 (700 W) 0.78% on
# the card and 0.31% on the CPU (PERF.md), so the CPU-relative bound
# above cannot hold. A backward that treats the batch statistics as
# constants lies ~640x max |g| off (CPU, 96^2); the control below must fail
# this bound in the same run
BN_GRAD_ATOL = 2e-2
# surface: the composed model against the flagship U-Net on the same
# weights: the same kernels on the same tensors, so equal but for the
# order of a reduction inside a library kernel
COMPOSED_SAME_ATOL = 1e-6
START = time.perf_counter()


def log(phase, **fields):
    """One line of a phase's figures, with the seconds since the script's
    imports, so that a run's time can be split by phase."""
    fields["since_start_s"] = time.perf_counter() - START
    print(f"[{phase}] {json.dumps(fields)}", flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


@contextlib.contextmanager
def _tf32_off():
    """Full float32 in cuDNN's convolutions and in matmuls inside the
    block (torch lets cuDNN use TF32 by default); the flags come back
    after it, so later phases run at the port's defaults."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def cuda_ms(fn, reps):
    """Mean time of ``fn`` on the card over ``reps`` runs after one warm
    run, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps):
    """Time per call of ``fn`` from CUDA events around one replay of a CUDA
    graph of ``reps`` calls: the card's time with no host work between the
    launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def self_device_us(evt):
    """Device time (us) of a profiler event, under the name of this torch's
    version."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return getattr(evt, attr)
    raise RuntimeError("the profiler's events carry no device time")


def device_us(fn, reps, names):
    """Device time of ``fn`` from torch.profiler over ``reps`` calls after
    one warm call: microseconds per call of the kernels whose names hold one
    of ``names`` (each kernel's mean over the launches the profiler
    recorded), summed and by name, or None where the profiler saw none. A
    kernel seen with no device time fails the run."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    time_us = {name: 0.0 for name in names}
    count = {name: 0 for name in names}
    for evt in prof.key_averages():
        if evt.device_type.name != "CUDA":
            continue
        for name in names:
            if name in evt.key:
                time_us[name] += self_device_us(evt)
                count[name] += evt.count
    for name in names:
        check(not count[name] or time_us[name] > 0,
              f"profiler: {count[name]} launches of {name} with no device "
              "time")
    by_name = {name: time_us[name] / count[name] if count[name] else None
               for name in names}
    if not all(count.values()):
        return None, by_name
    return sum(by_name.values()), by_name


def _min_index_labels(mask, structure=None):
    """scipy's labels of one mask, each component renamed to its min
    linear index (background INF)."""
    lab, n = scipy.ndimage.label(mask, structure=structure)
    first = np.full(n + 1, INF, np.int64)
    np.minimum.at(first, lab.ravel(), np.arange(lab.size))
    return np.where(lab > 0, first[lab], INF).astype(np.int32)


def scipy_min_index_labels(masks, structure=None):
    """scipy labels of each mask of a stack (4-connected slices by default;
    26-connected volumes with ``structure=CUBE``), min-index ids."""
    return np.stack([_min_index_labels(m, structure) for m in masks])


def kept_reference(labels):
    """Largest component per slice from min-index labels (numpy): ties go to
    the smallest id, empty slices stay empty."""
    kept = np.zeros(labels.shape, bool)
    for i, lab in enumerate(labels):
        ids, counts = np.unique(lab[lab < INF], return_counts=True)
        if ids.size:
            kept[i] = lab == ids[np.argmax(counts)]
    return kept


def _discs(rng, z, h, w, values):
    """Landmark-like label volume [Z, H, W]: per slice and label value one
    disc of radius 3 and 0-4 discs of radius 1-2 at random centres (about
    0.1% foreground per label at 224^2); a later value overwrites an
    earlier one."""
    yy, xx = np.mgrid[0:h, 0:w]
    pred = np.zeros((z, h, w), np.uint8)
    for k in range(z):
        for val in values:
            n_small = rng.integers(0, 5)
            for radius in (3, *rng.integers(1, 3, n_small)):
                cy, cx = rng.integers(0, h), rng.integers(0, w)
                pred[k][np.hypot(yy - cy, xx - cx) <= radius] = val
    return pred


def k2_cases():
    rng = np.random.default_rng(SEED)
    cases = {f"random-{d}": rng.random((Z, H, W)) < d
             for d in (0.3, 0.55, 0.7)}
    serp = np.zeros((H, W), bool)
    for r in range(0, H, 2):  # boustrophedon corridor: longest geodesic
        serp[r, :] = True
        if r + 1 < H:
            serp[r + 1, -1 if (r // 2) % 2 == 0 else 0] = True
    cases["serpentine"] = np.repeat(serp[None], Z, axis=0)
    edge = np.zeros((Z, H, W), bool)
    edge[1::3] = True                      # full slices
    edge[2, 0, 0] = edge[5, H - 1, W - 1] = edge[8, H // 2, W // 3] = True
    cases["empty-full-single"] = edge      # the rest stay empty
    # what the serving path gives K2: label 1's and label 2's masks of a
    # z=10 study stacked
    pred = _discs(rng, Z, H, W, (1, 2))
    cases["landmark-like"] = np.concatenate([pred == 1, pred == 2])
    cases["random-0.55-512"] = rng.random((4, 512, 512)) < 0.55
    return cases


def _k2_bound_ms(shape):
    """Least time of K2 on an [N, H, W] stack: 1 B of mask read and 4 B of
    labels written per pixel over HBM."""
    return int(np.prod(shape)) * (1 + 4) / HBM_BYTES_S * 1e3


def phase_k2():
    """Exact equality of the kernel with the plain version and scipy, and of
    two launches with each other."""
    results, max_err = {}, 0
    for name, masks in k2_cases().items():
        dev = torch.from_numpy(masks).cuda()
        got = kernels.converge_labels_cuda(dev)
        again = kernels.converge_labels_cuda(dev)
        plain = cc.label_components_2d(dev)
        torch.cuda.synchronize()
        err = int((got.long() - plain.long()).abs().max())
        max_err = max(max_err, err)
        check(err == 0, f"k2 {name}: kernel != plain (max abs {err})")
        check(torch.equal(got, again), f"k2 {name}: two launches differ")
        want = scipy_min_index_labels(masks)
        check(np.array_equal(got.cpu().numpy(), want),
              f"k2 {name}: kernel != scipy")
        check(np.array_equal(cc.largest_component_batch(dev).cpu().numpy(),
                             kept_reference(want)),
              f"k2 {name}: kept masks on the card != scipy's")
        slow = name in ("serpentine", "random-0.55-512")
        ms = cuda_ms(lambda: kernels.converge_labels_cuda(dev), 50)
        g_ms = graph_ms(lambda: kernels.converge_labels_cuda(dev), 20)
        dev_us, by_kernel = device_us(
            lambda: kernels.converge_labels_cuda(dev), 20, K2_KERNELS)
        plain_ms = cuda_ms(lambda: cc.label_components_2d(dev),
                           2 if slow else 10)
        results[name] = {"shape": list(masks.shape), "ms": ms,
                         "graph_ms": g_ms, "device_us": dev_us,
                         "plain_ms": plain_ms,
                         "bound_ms": _k2_bound_ms(masks.shape)}
        log("k2", case=name, shape=list(masks.shape),
            foreground=float(masks.mean()), exact=True, repeatable=True,
            ms=ms, graph_ms=g_ms, device_us=dev_us,
            device_us_by_kernel=by_kernel,
            plain_ms=plain_ms, bound_us=_k2_bound_ms(masks.shape) * 1e3)
    return results, max_err


def _errors(out, ref):
    return {"max": float(np.abs(out - ref).max()),
            "mean": float(np.abs(out - ref).mean())}


def _without_norm(model, block):
    """A copy of ``model`` whose ConvBlock ``block`` skips its norm."""
    control = copy.deepcopy(model)
    control.get_submodule(block).norm_name = None
    return control


def phase_forward(cfg, phase="forward", bf16_max=BF16_MAX_ATOL,
                  bf16_mean=BF16_MEAN_ATOL):
    """Flagship forward: card bf16 and card f32 against the CPU, and
    control forwards that the bf16 bounds must reject."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(cfg).reset_parameters(
        torch.Generator().manual_seed(SEED)).eval()
    f32_cfg = dict(cfg, MIXED_PRECISION=False)
    cpu = build_model(f32_cfg).eval()
    cpu.load_state_dict(model.state_dict())
    card_f32 = build_model(f32_cfg).eval()
    card_f32.load_state_dict(model.state_dict())
    batch = int(cfg["BATCHSIZE"])
    x = np.random.default_rng(SEED).standard_normal(
        (batch, H, W, 1)).astype(np.float32)
    with torch.inference_mode():
        ref = cpu(torch.from_numpy(x)).numpy()
        xd = torch.from_numpy(x).cuda()
        model.cuda()
        card_f32.cuda()
        bf16 = model(xd).cpu().numpy()
        f32 = card_f32(xd).cpu().numpy()
        ms = cuda_ms(lambda: model(xd), 20)
        ms_f32 = cuda_ms(lambda: card_f32(xd), 20)
        controls = {"constant_0.5": _errors(np.full_like(ref, 0.5), ref)}
        for block in ("ConvBlock_1", f"UpBlock_{model.depth - 1}.ConvBlock_1"):
            out = _without_norm(model, block)(xd).cpu().numpy()
            controls[f"no_norm_{block}"] = _errors(out, ref)
    check(np.isfinite(bf16).all() and bf16.shape == (batch, H, W, 2),
          f"forward: bad output {bf16.shape}")
    f32_err, bf16_err = _errors(f32, ref), _errors(bf16, ref)
    bounds = {"f32_max": F32_ATOL, "bf16_max": bf16_max,
              "bf16_mean": bf16_mean}
    log(phase, batch=batch, dtype="bfloat16", ms=ms, f32_ms=ms_f32,
        use_upsample=bool(cfg.get("USE_UPSAMPLE", True)),
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        f32_vs_cpu_f32=f32_err, bf16_vs_cpu_f32=bf16_err,
        controls_vs_cpu_f32=controls, bounds=bounds)
    check(f32_err["max"] <= F32_ATOL,
          f"{phase}: card f32 max {f32_err['max']} > {F32_ATOL}")
    check(bf16_err["max"] <= bf16_max and bf16_err["mean"] <= bf16_mean,
          f"{phase}: card bf16 {bf16_err} outside the bounds {bounds}")
    for name, err in controls.items():
        check(err["max"] > bf16_max or err["mean"] > bf16_mean,
              f"{phase}: control {name} {err} passes the bf16 bounds, which "
              "therefore cannot tell a wrong forward from bf16 rounding")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = prev
    return model.cpu()


def _phantom(rng, z, ny, nx):
    """Short-axis-like stack: a bright blood pool and a myocardial ring on
    noise, drifting across slices."""
    yy, xx = np.mgrid[0:ny, 0:nx].astype(np.float32)
    vol = rng.normal(200.0, 40.0, (z, ny, nx)).astype(np.float32)
    for k in range(z):
        cy, cx = ny / 2 + 3 * np.sin(k), nx / 2 + 3 * np.cos(k)
        r = np.hypot(yy - cy, xx - cx)
        vol[k] += 600.0 * (r < 18 + k) + 300.0 * ((r > 24 + k) & (r < 32 + k))
    return vol


def phase_serve(cfg, model):
    """Serve synthetic studies through the CLI entry point."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        fold = os.path.join(work, "fold")
        os.makedirs(os.path.join(fold, "config"))
        with open(os.path.join(fold, "config", "config.json"), "w") as fh:
            json.dump(cfg, fh)
        save_weights(os.path.join(fold, "model"), model)
        return _serve_fold(fold, work, "serve", {"msk": {0, 1, 2}})


# the serving phases' synthetic studies: name -> origin
STUDIES = {"study0.nrrd": (0.0, 0.0, 0.0),
           "study1.nii.gz": (-120.5, 80.25, 30.0),
           "study2.nrrd": (12.0, -7.5, -45.0)}


def _write_studies(in_dir):
    """The 3 synthetic studies (z=10, 256 x 216 at 1.5625 mm) in
    ``in_dir``, settled."""
    rng = np.random.default_rng(SEED)
    os.makedirs(in_dir)
    for name, origin in STUDIES.items():
        path = os.path.join(in_dir, name)
        write_image(MedicalImage(array=_phantom(rng, Z, 216, 256),
                                 spacing=(1.5625, 1.5625, 10.0),
                                 origin=origin), path)
        os.utime(path, (0, 0))  # settled


def _serve_fold(fold, work, phase, outputs, kernel="k2", source="-exp"):
    """Serve 3 synthetic studies from ``fold`` through cli.serve (``source``
    names the route: ``-exp`` a fold, ``-artifact`` an export,
    ``-ensemble`` a CV root). Each study writes one
    ``<stem>_<suffix>_pred.nrrd`` per entry of ``outputs`` (suffix ->
    allowed labels) in its own geometry; the CC kernel (``kernel``: "k2",
    or "cc3d" for CC_FILTER '3d') launches once per study and head, plus
    once for the engine's warm-up, and the other kernels no time. Every
    count is set to 0 before the serve and read after it; returns them."""
    studies = STUDIES
    in_dir, out_dir = os.path.join(work, "in"), os.path.join(work, "out")
    _write_studies(in_dir)

    _reset_all()
    t0 = time.perf_counter()
    totals = serve_main([source, fold, "-in", in_dir, "-out", out_dir,
                         "--max-studies", str(len(studies)),
                         "--device", DEV])
    wall_s = time.perf_counter() - t0
    launches = _counts()

    check(totals["studies"] == len(studies), f"{phase}: totals {totals}")
    latencies, labels = {}, {}
    for name, origin in studies.items():
        stem = name.split(".")[0]
        with open(os.path.join(out_dir, f"{stem}.done.json")) as fh:
            record = json.load(fh)
        check("error" not in record, f"{phase} {name}: {record}")
        check(record["outputs"] == [f"{stem}_{suffix}_pred.nrrd"
                                    for suffix in outputs],
              f"{phase} {name}: outputs {record['outputs']}")
        for suffix, allowed in outputs.items():
            pred = read_image(os.path.join(out_dir,
                                           f"{stem}_{suffix}_pred.nrrd"))
            check(pred.array.shape == (Z, 216, 256),
                  f"{phase} {name}: shape {pred.array.shape}")
            check(np.allclose(pred.spacing, (1.5625, 1.5625, 10.0)),
                  f"{phase} {name}: spacing {pred.spacing}")
            check(np.allclose(pred.origin, origin),
                  f"{phase} {name}: origin {pred.origin}")
            found = set(np.unique(pred.array).tolist())
            check(found <= allowed, f"{phase} {name}: {suffix} labels {found}")
            labels[suffix] = sorted(set(labels.get(suffix, [])) | found)
        latencies[name] = {k: record[k] for k in
                           ("read_s", "preprocess_s", "forward_s",
                            "post_write_s", "total_s", "slices")}
    # one launch per study and head (a head's label values stacked), plus
    # the engine's warm-up
    want = dict({"k1": 0, "k2": 0, "cc3d": 0},
                **{kernel: len(studies) * len(outputs) + 1})
    check(launches == want,
          f"{phase}: launches {launches} for {len(studies)} studies and "
          f"{len(outputs)} heads, want {want}")
    check("jax" not in sys.modules, f"{phase}: jax was imported")
    log(phase, studies=len(studies), launches=launches, wall_s=wall_s,
        totals=totals, latencies=latencies, labels_served=labels)
    return launches


def phase_build():
    """One build of every kernel: nvcc per source, all started together."""
    t0 = time.perf_counter()
    report = kernels.build()
    keep = ("Compiling entry function", "registers", "spill", "smem")
    log("build", seconds=time.perf_counter() - t0,
        sources=[os.path.relpath(src) for src in kernels.SOURCES],
        ptxas=[line.strip() for line in report.splitlines()
               if any(k in line for k in keep)])


def _blur_bound(shape, sigma):
    """Least time of one blur of a float32 [N, H, W] stack on the card:
    every input byte read once and every output byte written once over HBM,
    against 2 passes x (2r+1) multiply-adds per pixel at the f32 peak."""
    n, h, w = shape
    taps = gaussian_kernel1d(sigma).size
    bytes_moved = 2 * n * h * w * 4
    flops = n * h * w * 2 * taps * 2
    t_bytes, t_ops = bytes_moved / HBM_BYTES_S, flops / F32_FLOP_S
    return {"bound_us": max(t_bytes, t_ops) * 1e6,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "flops": flops}


def _blur_library(x, sigma):
    """Yardstick, never called by the port: symmetric pad by index gather,
    then cuDNN convolutions with the (2r+1) x 1 and 1 x (2r+1) taps."""
    k = torch.from_numpy(gaussian_kernel1d(sigma)).to(x.device)
    r = (k.numel() - 1) // 2
    n, h, w = x.shape
    padded = x.index_select(1, symmetric_index(h, r, x.device)).index_select(
        2, symmetric_index(w, r, x.device))
    out = F.conv2d(padded[:, None], k.view(1, 1, -1, 1))
    return F.conv2d(out, k.view(1, 1, 1, -1))[:, 0]


def _k1_times(dev, sigma):
    """K1's time with L2 warm (back-to-back launches on one input, as the
    train step finds its just-written targets) by CUDA events around
    wrapper calls (host work included) and around a CUDA graph of launches,
    and with L2 flushed by a 64 MB write before each launch in the graph (a
    graph of the writes alone timed apart and taken off)."""
    def blur():
        return kernels.gaussian_blur_2d_cuda(dev, sigma)

    scratch = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev.device)

    def flush():
        scratch.fill_(1)

    def flushed_blur():
        flush()
        blur()

    flush_ms = graph_ms(flush, 20)
    return {"ms": cuda_ms(blur, 200), "graph_ms": graph_ms(blur, 50),
            "cold_graph_ms": graph_ms(flushed_blur, 20) - flush_ms,
            "flush_graph_ms": flush_ms,
            "plain_ms": cuda_ms(lambda: gaussian_blur_2d(dev, sigma), 20),
            "library_ms": cuda_ms(lambda: _blur_library(dev, sigma), 50)}


def k1_cases():
    rng = np.random.default_rng(SEED)
    main_path = (2 * 16, 224, 224)  # B * C = 16 * 2 heatmap channels
    # pred_fold blurs one patient-phase's binary landmark channels: z * C
    pred_path = _discs(rng, Z, H, W, (1, 2))
    cases = [("main-s2", rng.random(main_path, np.float32), 2.0),
             ("pred-s2", np.concatenate([pred_path == 1, pred_path == 2])
              .astype(np.float32), 2.0),
             ("main-s1", rng.random(main_path, np.float32), 1.0),
             ("main-s4", rng.random(main_path, np.float32), 4.0),
             ("odd-37x53", rng.random((3, 37, 53), np.float32), 2.0),
             ("r-ge-side", rng.random((2, 12, 12), np.float32), 4.0),
             # radii the kernel reads at run time (not template constants)
             ("s1.5-odd", rng.random((3, 37, 53), np.float32), 1.5),
             ("s3-r-ge-side", rng.random((2, 10, 8), np.float32), 3.0),
             # too wide for one block: column chunks
             ("wide-chunks", rng.random((2, 300, 2600), np.float32), 2.0)]
    impulse = np.zeros((1, 64, 64), np.float32)
    impulse[0, 32, 32] = 1.0
    cases.append(("impulse", impulse, 2.0))
    return cases


def phase_k1(cases=None, phase="k1"):
    """K1 against its plain version on the card and scipy on the host, on
    ``cases`` (``k1_cases()`` by default); the main paths' shapes timed."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the yardstick in full f32
    results, max_err = {}, 0.0
    try:
        for name, host, sigma in cases or k1_cases():
            dev = torch.from_numpy(host).cuda()
            got = kernels.gaussian_blur_2d_cuda(dev, sigma)
            plain = gaussian_blur_2d(dev, sigma)
            library = _blur_library(dev, sigma)
            torch.cuda.synchronize()
            want = np.stack([scipy.ndimage.gaussian_filter(
                v.astype(np.float64), sigma, mode="reflect", truncate=4.0)
                for v in host])
            out = got.cpu().numpy()
            err_plain = float((got - plain).abs().max())
            err_scipy = float(np.abs(out - want).max())
            err_library = float((got - library).abs().max())
            max_err = max(max_err, err_plain, err_scipy)
            check(err_plain <= K1_ATOL and err_scipy <= K1_ATOL,
                  f"k1 {name}: max abs {err_plain} vs plain, {err_scipy} vs "
                  f"scipy (atol {K1_ATOL})")
            fields = {"case": name, "shape": list(host.shape),
                      "sigma": sigma, "err_plain": err_plain,
                      "err_scipy": err_scipy, "err_library": err_library}
            if name == "impulse":
                total = float(out.sum())
                check(abs(total - 1.0) <= 1e-4, f"k1 impulse sums to {total}")
                fields["impulse_sum"] = total
            if name.startswith(("main", "pred", "cine")):
                fields.update(_k1_times(dev, sigma), **_blur_bound(
                    host.shape, sigma))
                results[name] = fields
            log(phase, **fields)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return results, max_err


def _make_dataset(root):
    """The phantom cohort of the port's full_cv_demo tool (8 patients x
    ED/ES x 10 slices of 200 x 200 at 1.37 mm, ventricle masks, RVIP
    masks, 4D cines) sliced by the make_dataset CLI, which writes a 4-fold
    df_kfold.csv: fold 0 trains on 6 patients (120 slices) and validates on
    2 (40 slices, so the val set ends in a remainder batch)."""
    generate_cohort(root, n_patients=COHORT_PATIENTS, n_slices=Z)
    make_dataset_main(["-data_root", root,
                       "-acdc_data", os.path.join(root, "original")])


class _Spans(logging.Handler):
    """pred_fold's spans (``TIMING_LOG``), each with both kernels' launch
    counts at the moment it was logged."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.records = []

    def emit(self, record):
        self.records.append(dict(
            record.timing, k1=kernels.gaussian_blur_2d_cuda.launches,
            k2=kernels.converge_labels_cuda.launches))

    def __enter__(self):
        TIMING_LOG.setLevel(logging.DEBUG)
        TIMING_LOG.addHandler(self)
        return self

    def __exit__(self, *exc):
        TIMING_LOG.removeHandler(self)

    def predict_4d(self):
        """The one predict_4d_on_2d_cv call logged: its wall seconds and
        its per-file spans."""
        starts = [r for r in self.records if r["event"] == "4d_start"]
        ends = [r for r in self.records if r["event"] == "4d_end"]
        check(len(starts) == len(ends) == 1,
              f"predict_4d spans: {len(starts)} starts, {len(ends)} ends")
        return {"wall_s": ends[0]["wall_s"],
                "files": [r for r in self.records if r["event"] == "4d_file"]}

    def pred_fold(self):
        """The one pred_fold call logged: launches of each kernel in it,
        launches before it, its wall seconds and its patient-phases."""
        starts = [r for r in self.records if r["event"] == "start"]
        ends = [r for r in self.records if r["event"] == "end"]
        check(len(starts) == len(ends) == 1,
              f"pred_fold spans: {len(starts)} starts, {len(ends)} ends")
        (start,), (end,) = starts, ends
        return {"k1": end["k1"] - start["k1"], "k2": end["k2"] - start["k2"],
                "k1_before": start["k1"], "k2_before": start["k2"],
                "wall_s": end["wall_s"],
                "phases": [r for r in self.records if r["event"] == "phase"]}


def _ms_per_phase(phases):
    """Median ms of each pred_fold stage over the patient-phases."""
    keys = ("load_s", "finalize_s", "forward_s", "cc_s", "write_s",
            "total_s")
    return {k[:-2] + "_ms": float(np.median([p[k] for p in phases])) * 1e3
            for k in keys}


def _check_predictions(fold, test_patients, seg=False):
    """pred/, gt/ and _cmr files (and the _seg files of a multihead fold)
    of every test patient x ED/ES in the cohort's geometry; returns their
    modification times."""
    mtimes = {}
    files = (("pred", "msk"), ("gt", "msk"), ("pred", "cmr")) \
        + ((("pred", "seg"), ("gt", "seg")) if seg else ())
    for p in test_patients:
        for phase in ("ED", "ES"):
            for sub, tail in files:
                path = os.path.join(fold, sub, f"{p}_{phase}_{tail}.nrrd")
                img = read_image(path)
                check(img.array.shape == (Z, COHORT_HW, COHORT_HW)
                      and np.allclose(img.spacing, COHORT_SPACING),
                      f"{path}: shape {img.array.shape}, spacing "
                      f"{img.spacing}")
                if tail in ("msk", "seg"):
                    allowed = {0, 1, 2} if tail == "msk" else {0, 1, 2, 3}
                    check(set(np.unique(img.array)) <= allowed,
                          f"{path}: labels {np.unique(img.array)}")
                if sub == "gt":  # every cohort slice holds every label
                    values = (1, 2) if tail == "msk" else (1, 2, 3)
                    check(all((img.array == v).any() for v in values),
                          f"{path}: a gt label is missing")
                mtimes[path] = os.path.getmtime(path)
    return mtimes


def _loaded_foreign():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "cmrtpu"))


def _time_steps(cfg, data_root, steps=12, warm=3):
    """``_time_loop`` of a fresh trainer's cached loop over fold 0's
    training slices of the sliced cohort under ``data_root``."""
    x_tr, y_tr, _, _ = get_trainings_files(
        os.path.join(data_root, "2D"), 0,
        os.path.join(data_root, "df_kfold.csv"))
    trainer = Trainer(cfg, device="cuda")
    loop = DeviceCachedLoop(trainer, DataGenerator(x_tr, y_tr, config=cfg))
    return _time_loop(loop, steps, warm)


def _device_ms_by_kernel(fn, host=True):
    """``fn()`` under torch.profiler, synchronized: device ms by kernel
    (empty when the profiler saw no device time; host-device copies, which
    may overlap kernels on a side stream, are not kernels) and the wall
    ms. ``host`` False records the device's activity only, which keeps a
    long window's trace small."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for evt in prof.key_averages():
        dev_us = self_device_us(evt)
        # user annotations (Optimizer.step#Adam.step) span the kernels they
        # launch on the device timeline: counting them would count twice
        annotation = getattr(evt, "is_user_annotation", False) \
            or evt.key.startswith("Optimizer.")
        if dev_us > 0 and evt.device_type.name == "CUDA" and not annotation \
                and not evt.key.startswith("Memcpy"):
            by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + dev_us / 1e3
    return by_kernel, wall_ms


def _time_loop(loop, steps=12, warm=3):
    """Median train-step time over warm steps of the cached loop (CUDA
    events around each step), then a torch.profiler window of 4 steps:
    device time by kernel and the card's idle share in that window."""
    idx = torch.from_numpy(loop._epoch_indices(loop.n_train, True)).cuda()
    for s in range(warm):
        loop.train_step(idx[s % len(idx)])
    torch.cuda.synchronize()
    times = []
    for s in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loop.train_step(idx[s % len(idx)])
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    step_ms = float(np.median(times))
    match = {}
    if loop._match_fn is not None:  # Var.1: the matcher alone, per step
        match_times = []
        for s in range(steps):
            imgs, _ = loop._gather(loop.x_train, loop.y_train,
                                   idx[s % len(idx)])
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loop.hist_match(imgs, loop.x_train)
            end.record()
            torch.cuda.synchronize()
            match_times.append(start.elapsed_time(end))
        match = {"match_ms_per_step_median": float(np.median(match_times)),
                 "match_candidates_per_step": loop._quota,
                 "match_gate_p": loop._gate_p}

    window = 4

    def profiled():
        for s in range(window):
            loop.train_step(idx[s % len(idx)])

    by_kernel, wall_ms = _device_ms_by_kernel(profiled)
    busy_ms = sum(by_kernel.values())
    if not busy_ms:  # the profiler saw no device time: not measured
        return {"step_ms_median": step_ms, "timed_steps": steps,
                "examples_per_s": loop.batch / (step_ms / 1e3),
                "device_busy_ms": None, "idle_share": None, **match}
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    k1_ms = sum(v for k, v in by_kernel.items() if "gaussian_blur" in k)
    busy_step = busy_ms / window
    return {"step_ms_median": step_ms, "step_ms_min": float(min(times)),
            "step_ms_max": float(max(times)), "timed_steps": steps,
            "examples_per_s": loop.batch / (step_ms / 1e3),
            "profiled_steps": window, "profiled_wall_ms": wall_ms,
            "device_busy_ms_per_step": busy_step,
            # share of the profiled window (the profiler slows the host)
            # and of the unprofiled median step in which no kernel ran
            "idle_share_profiled": 1.0 - busy_ms / wall_ms,
            "idle_share": 1.0 - busy_step / step_ms,
            "k1_device_ms_per_step": k1_ms / window,
            "device_ms_by_kernel": {k[:90]: v / window for k, v in top},
            **match}


def _train_cli(cfg, data_root, work, name, args=(), spans=True):
    """Train ``cfg`` through cli.train (chained pred_fold) on the sliced
    cohort, with ``args`` added to the command line; returns the run dir,
    the kernels' launches, pred_fold's span (None with ``spans`` False: a
    skipped fold runs none) and the wall seconds."""
    cfg_path = os.path.join(work, f"{name}.json")
    with open(cfg_path, "w") as fh:
        json.dump(cfg, fh)
    cwd = os.getcwd()
    os.chdir(work)  # EXPERIMENTS_ROOT 'exp/' lands in the work dir
    try:
        kernels.gaussian_blur_2d_cuda.launches = 0
        kernels.converge_labels_cuda.launches = 0
        t0 = time.perf_counter()
        with _Spans() as logged:
            exp = os.path.abspath(train_main(
                ["-cfg", cfg_path, "-data", data_root, *args]))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        k1 = kernels.gaussian_blur_2d_cuda.launches
        k2 = kernels.converge_labels_cuda.launches
    finally:
        os.chdir(cwd)
    return exp, k1, k2, logged.pred_fold() if spans else None, wall_s


def phase_train(cfg):
    """Train the flagship config for 2 epochs through the CLI entry point on
    the cohort that make_dataset sliced, with the chained pred_fold, then
    serve the model.npz it wrote, time warm train steps, predict the fold
    again through the predict CLI and evaluate it through the evaluate_cv
    CLI; then CC_FILTER '3d' through both CLIs, the 4D cine paths and the
    override twin on the same fold. FOLDS is cut to [0]. Returns each
    kernel's launches by path, the warm step's timing and K2's and the 3D
    kernel's figures at a cine's stacked shapes."""
    cfg = dict(cfg, EPOCHS=2, FOLDS=[0])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as work:
        data_root = os.path.join(work, "data")
        _make_dataset(data_root)
        profiling.GLOBAL_TIMER.reset()
        writer_calls, builds = [], []
        with _patched(train_callbacks.ImageWriter, "on_epoch_end",
                      _counting_forwards(writer_calls)), \
                _patched(DataGenerator, "__init__", _timed(builds)):
            exp, launches, k2_launches, chained, wall_s = _train_cli(
                cfg, data_root, work, "flagship")
        stages = profiling.GLOBAL_TIMER.summary()
        fold = os.path.join(exp, "f0")
        with open(os.path.join(fold, "history.csv")) as fh:
            rows = list(csv.DictReader(fh))
        check(len(rows) == 2, f"train: {len(rows)} history rows, want 2")
        keys = ("loss", "val_loss", "val_loc_mm")
        history = [{k: float(r[k]) for k in keys + ("val_loc_det",
                                                     "epoch_time")}
                   for r in rows]
        check(all(np.isfinite(h[k]) for h in history for k in keys),
              f"train: non-finite history {history}")
        npz = os.path.join(fold, "model", "model.npz")
        check(os.path.exists(npz), "train: no model.npz")
        n_train, n_val = 6 * 2 * Z, 2 * 2 * Z
        batch = int(cfg["BATCHSIZE"])
        train_steps = 2 * (n_train // batch)
        eval_steps = 2 * -(-n_val // batch)
        test = fold_patients(os.path.join(data_root, "df_kfold.csv"), 0)
        check(len(test) == 2, f"train: fold 0 tests {test}")
        phases = 2 * len(test)
        samples = _sample_launches(cfg)
        # K1: one launch per sample batch, train and eval step, then one
        # per patient-phase in the chained pred_fold; K2 only in pred_fold
        check(chained["k1_before"] == samples + train_steps + eval_steps
              and chained["k2_before"] == 0,
              f"train: {chained['k1_before']} K1 and {chained['k2_before']} "
              f"K2 launches for {samples} sample batches, {train_steps} "
              f"train and {eval_steps} eval steps")
        check(chained["k1"] == chained["k2"] == phases,
              f"train: the chained pred_fold launched K1 {chained['k1']} and "
              f"K2 {chained['k2']} times for {phases} patient-phases")
        check(launches == samples + train_steps + eval_steps + phases
              and k2_launches == phases,
              f"train: {launches} K1 and {k2_launches} K2 launches in all")
        check(len(chained["phases"]) == phases,
              f"train: {len(chained['phases'])} patient-phases predicted")
        mtimes = _check_predictions(fold, test)
        check(not _loaded_foreign(), f"train: loaded {_loaded_foreign()}")

        pred = Predictor(cfg, os.path.dirname(npz), device="cuda")
        x = np.random.default_rng(SEED).standard_normal(
            (4, 224, 224, 1)).astype(np.float32)
        served = pred.predict(x)
        check(served.shape == (4, 224, 224, 2) and np.isfinite(served).all(),
              f"train: the trained model serves {served.shape}")
        images = _check_image_writer(fold, writer_calls)
        timing = _time_steps(cfg, data_root)
        log("train", train_steps=train_steps, eval_steps=eval_steps,
            sample_batches=samples, k1_launches=launches,
            k2_launches=k2_launches, wall_s=wall_s, history=history,
            image_writer=images, **timing)
        _log_host_stage(stages, builds, wall_s, chained["wall_s"])
        phase_profile(cfg, data_root, work)
        predicted = phase_predict(fold, data_root, test, mtimes)
        evaluate_s = phase_evaluate(exp, data_root, phases)
        # main resets the 3D kernel's count after its own phase: the 2D
        # serving, training and prediction paths never launch it
        check(kernels.converge_labels_3d_cuda.launches == 0,
              "train: the 3D CC kernel launched on a 2D path")
        cc3d_paths = phase_cc3d_cli(fold, data_root, test, work)
        p4d_paths, cine_cc = phase_predict_4d(exp, fold, data_root, test,
                                              work)
        twin_paths = phase_override_twin(exp, data_root, test, work)
        extra_paths = phase_serving_extras(exp, fold, data_root, test, work)
        extra_paths.update(phase_ab_tools(exp, fold, data_root, test, work))
        t0 = time.perf_counter()
        _reset_all()  # the A/B tools' CC_FILTER '3d' path counted its own
        extra_paths.update(phase_ws(cfg, data_root, test, work))
        log("skip-list", ws_s=time.perf_counter() - t0)
    log("pred-eval", chained_pred_fold_wall_s=chained["wall_s"],
        chained_ms_per_patient_phase=_ms_per_phase(chained["phases"]),
        chained_patient_phases=chained["phases"],
        predict_cli_wall_s=predicted["wall_s"],
        predict_cli_ms_per_patient_phase=_ms_per_phase(predicted["phases"]),
        evaluate_cv_wall_s=evaluate_s)
    return {"train": {"k1": chained["k1_before"], "k2": chained["k2_before"]},
            "pred_fold": {"k1": chained["k1"], "k2": chained["k2"]},
            "predict_cli": {"k1": predicted["k1"], "k2": predicted["k2"]},
            **cc3d_paths, **p4d_paths, **twin_paths, **extra_paths}, \
        timing, cine_cc


def phase_predict(fold, data_root, test_patients, mtimes):
    """The predict CLI on the trained fold rewrites every output with one
    launch of each kernel per patient-phase."""
    kernels.gaussian_blur_2d_cuda.launches = 0
    kernels.converge_labels_cuda.launches = 0
    with _Spans() as spans:
        predict_main(["-exp", fold, "-data", data_root])
    k1 = kernels.gaussian_blur_2d_cuda.launches
    k2 = kernels.converge_labels_cuda.launches
    phases = 2 * len(test_patients)
    check(k1 == k2 == phases,
          f"predict: K1 {k1} and K2 {k2} launches for {phases} "
          "patient-phases")
    again = _check_predictions(fold, test_patients)
    check(all(again[f] > mtimes[f] for f in mtimes),
          "predict: an output was not rewritten")
    return dict(spans.pred_fold(), k1=k1, k2=k2)


def phase_evaluate(exp, data_root, phases):
    """The evaluate_cv CLI writes one df_eval.csv row per patient-phase with
    the columns of all four sources (pred, gt, io, original ventricle
    masks) and finite prediction distances. Returns its wall seconds."""
    t0 = time.perf_counter()
    evaluate_main(["-exp", exp, "-data", data_root])
    wall_s = time.perf_counter() - t0
    with open(os.path.join(exp, "df_eval.csv"), newline="") as fh:
        rows = list(csv.DictReader(fh))
    check(len(rows) == phases, f"evaluate: {len(rows)} rows, want {phases}")
    for col in ("ips_pred", "ips_gt", "ips_io", "ips_orig_msk",
                "mdists_ant_gtio", "mdists_ant_gtorig", "pathology"):
        check(col in rows[0] and all(r[col] for r in rows),
              f"evaluate: column {col} missing or empty")
    dists = [float(r[c] or "nan") for r in rows
             for c in ("mdists_ant_gtpred", "mdists_inf_gtpred")]
    check(np.isfinite(dists).all(), f"evaluate: prediction distances {dists}")
    log("evaluate", rows=len(rows), columns=len(rows[0]), wall_s=wall_s,
        mdists_gtpred_mm=dists,
        tpr_ppv_th15={c: [float(r[c]) for r in rows] for c in (
            "tpr_ant_point_th15", "ppv_ant_point_th15",
            "tpr_inf_point_th15", "ppv_inf_point_th15")})
    return wall_s


def _grads(model):
    return {n: p.grad.detach().double().cpu() for n, p in
            model.named_parameters()}


def _bn_stats_detached(self, x):
    """A wrong BatchNorm for the control: batch statistics without their
    backward."""
    mean = x.mean(dim=(0, 2, 3)).detach()
    var = torch.clamp(x.square().mean(dim=(0, 2, 3)) - mean.square(),
                      min=0.0).detach()
    mul = torch.rsqrt(var + self.eps) * self.weight
    return (x - mean[:, None, None]) * mul[:, None, None] \
        + self.bias[:, None, None]


def _moved_buffers(model, start):
    """How far one step moved each BatchNorm running average, in float64
    on the host."""
    return {n: b.detach().double().cpu() - start[n].double()
            for n, b in model.named_buffers()}


def phase_train_f32(cfg, phase="train-f32", grad_atol=None):
    """One f32 train step (TF32 off, dropout 0, no augmentation) at flagship
    width and batch on the card and on the CPU, from the same weights and
    batch, each against a float64 evaluation of the step on the CPU: the
    gradients and, for BatchNorm, the running averages the step moved.
    With ``grad_atol`` the card's gradients are held to it directly, and a
    control step whose BatchNorm drops the batch statistics' backward must
    lie beyond it."""
    cfg = dict(cfg, MIXED_PRECISION=False, DROPOUT_MIN=0.0, DROPOUT_MAX=0.0,
               AUGMENT=False)
    batch = int(cfg["BATCHSIZE"])
    rng = np.random.default_rng(SEED + 1)
    imgs = _phantom(rng, batch, H, W)
    msks = np.zeros((batch, H, W), np.float32)
    for b in range(batch - 2):  # the last two slices hold no landmark
        msks[b, 60 + b:64 + b, 120:124] = 1
        msks[b, 100 + b:104 + b, 116:120] = 2
    x, y = finalize_batch(torch.from_numpy(imgs), torch.from_numpy(msks), cfg)
    weights = init_model(cfg).state_dict()
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        steps = {}
        for device in ("cuda", "cpu"):
            trainer = Trainer(cfg, device=device)
            trainer.model.load_state_dict(weights)
            t0 = time.perf_counter()
            logs = trainer.state.train_step(x.to(device), y.to(device))
            loss = float(logs["loss"])
            steps[device] = (loss, _grads(trainer.model),
                             time.perf_counter() - t0,
                             _moved_buffers(trainer.model, weights))
        if grad_atol is not None:
            trainer = Trainer(cfg, device="cuda")
            trainer.model.load_state_dict(weights)
            for mod in trainer.model.modules():
                if isinstance(mod, BatchNorm):
                    mod.forward = types.MethodType(_bn_stats_detached, mod)
            trainer.state.train_step(x.cuda(), y.cuda())
            g_control = _grads(trainer.model)
        ref = build_model(cfg)
        ref.load_state_dict(weights)
        ref.double()
        for mod in ref.modules():
            if hasattr(mod, "dtype"):
                mod.dtype = torch.float64
        ref_state = TrainState(ref, torch.optim.SGD(ref.parameters(), lr=0.0),
                               trainer.loss_fn, {})
        loss64 = float(ref_state.train_step(x.double(), y.double())["loss"])
        g64 = _grads(ref)
        b64 = _moved_buffers(ref, weights)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev

    def rel(a, b, scale):
        return float((a - b).abs().max() / scale)

    (loss_card, g_card, s_card, b_card), (loss_cpu, g_cpu, s_cpu, b_cpu) = \
        steps["cuda"], steps["cpu"]
    per_param = {}
    for name, ref_g in {**g64, **b64}.items():
        card, cpu = (g_card, g_cpu) if name in g64 else (b_card, b_cpu)
        scale = float(ref_g.abs().max()) or 1.0
        per_param[name] = (rel(card[name], ref_g, scale),
                           rel(cpu[name], ref_g, scale),
                           rel(card[name], cpu[name], scale))
    check(not b64 or all(float(v.abs().max()) > 0 for v in b64.values()),
          f"{phase}: the step left a running average where it was")
    worst = max(per_param, key=lambda n: per_param[n][0] - per_param[n][1])
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    control = {}
    if grad_atol is not None:
        control = {"grad_atol": grad_atol, "control_stats_detached_max": max(
            rel(g_control[n], g, float(g.abs().max()) or 1.0)
            for n, g in g64.items())}
    log(phase, batch=batch, running_averages=len(b64), **control, loss_card=loss_card, loss_cpu=loss_cpu,
        loss_f64=loss64, loss_rel=loss_rel, loss_rtol=LOSS_RTOL,
        grad_card_vs_f64_max=max(v[0] for v in per_param.values()),
        grad_cpu_vs_f64_max=max(v[1] for v in per_param.values()),
        grad_card_vs_cpu_max=max(v[2] for v in per_param.values()),
        worst_param=worst, worst=per_param[worst], grad_extra=GRAD_EXTRA,
        card_step_s=s_card, cpu_step_s=s_cpu,
        cudnn_allow_tf32=False, matmul_allow_tf32=False)
    check(loss_rel <= LOSS_RTOL,
          f"{phase}: loss card {loss_card} vs CPU {loss_cpu}")
    if grad_atol is not None:
        check(control["control_stats_detached_max"] > grad_atol,
              f"{phase}: the control {control} passes the bound, which "
              "therefore cannot tell a wrong BatchNorm backward")
    for name, (card, cpu, _) in per_param.items():
        if grad_atol is not None and name in g64:
            check(card <= grad_atol,
                  f"{phase}: {name} gradient on the card lies {card} x "
                  f"max|g| from float64 (bound {grad_atol})")
            continue
        check(card <= cpu + GRAD_EXTRA,
              f"{phase}: {name} gradient (or running-average step) on the "
              f"card lies {card} x max|g| from float64, the CPU's {cpu}")


def _cache_like(rng, n):
    """[n, 224, 224] slices as the padded cache holds them: MinMax-scaled
    phantoms of 200 x 200 centred in zeros (H - 24 x W - 24 in general)."""
    out = np.zeros((n, H, W), np.float32)
    vol = _phantom(rng, n, H - 24, W - 24)
    lo = vol.min(axis=(1, 2), keepdims=True)
    hi = vol.max(axis=(1, 2), keepdims=True)
    out[:, 12:H - 12, 12:W - 12] = (vol - lo) / (hi - lo)
    return out


def phase_histmatch():
    """The binned matcher (HIST_MATCHING_BINS 2048, zeros excluded, as the
    cached loop runs it) on the card against its CPU version on the same
    [16, 224, 224] sources and references: equal bin indices, values within
    HIST_ATOL; then its time on the card for the whole batch."""
    rng = np.random.default_rng(SEED + 2)
    src, ref = _cache_like(rng, 16), _cache_like(rng, 16)
    bins = 2048
    cpu = match_histograms_binned(torch.from_numpy(src),
                                  torch.from_numpy(ref), bins, True)
    s_dev, r_dev = torch.from_numpy(src).cuda(), torch.from_numpy(ref).cuda()
    card = match_histograms_binned(s_dev, r_dev, bins, True)
    idx_cpu = _binned_cdf(torch.from_numpy(src).reshape(16, -1), bins,
                          True)[3]
    idx_card = _binned_cdf(s_dev.reshape(16, -1), bins, True)[3]
    torch.cuda.synchronize()
    err = float((card.cpu() - cpu).abs().max())
    same_bins = bool(torch.equal(idx_card.cpu(), idx_cpu))
    ms = cuda_ms(lambda: match_histograms_binned(s_dev, r_dev, bins, True),
                 20)
    log("histmatch", shape=list(src.shape), bins=bins, exclude_zeros=True,
        max_abs_err=err, atol=HIST_ATOL, bin_indices_equal=same_bins,
        ms_batch_of_16=ms, cpu_changed=float((cpu - torch.from_numpy(src))
                                             .abs().max()))
    check(same_bins, "histmatch: bin indices on the card differ from the CPU")
    check(err <= HIST_ATOL, f"histmatch: card vs CPU max abs {err}")
    check(bool((card[s_dev == 0] == 0).all()),
          "histmatch: a zero border pixel was matched")


def phase_variants(flagship_timing):
    """The four other shipped 2D templates at their own widths (EPOCHS 2,
    FOLDS [0]) on one cohort with _seg targets: cli.train with the chained
    pred_fold, exact launch counts, cli.evaluate_cv, and per template the
    warm step beside the flagship's GroupNorm step of this run; the
    multihead fold then serves. Returns the launches by path."""
    by_path = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_variants_") as work:
        data_root = os.path.join(work, "data")
        _make_dataset(data_root)
        _write_seg_slices(data_root)
        test = fold_patients(os.path.join(data_root, "df_kfold.csv"), 0)
        phases = 2 * len(test)
        for name, (blurs, heads) in VARIANTS.items():
            tag = name.replace("_config.json", "")
            with open(os.path.join(TEMPLATES, name), encoding="utf-8") as fh:
                cfg = dict(json.load(fh), EPOCHS=2, FOLDS=[0])
            exp, k1, k2, chained, wall_s = _train_cli(cfg, data_root, work,
                                                      tag)
            batch = int(cfg["BATCHSIZE"])
            steps = 2 * (6 * 2 * Z // batch) + 2 * -(-(2 * 2 * Z) // batch)
            steps += _sample_launches(cfg)
            want_k1 = (steps + phases) if blurs else 0
            check(k1 == want_k1 and k2 == phases * heads,
                  f"variants {tag}: K1 {k1} (want {want_k1}), K2 {k2} "
                  f"(want {phases * heads})")
            check(chained["k1_before"] == (steps if blurs else 0)
                  and chained["k2_before"] == 0
                  and chained["k2"] == phases * heads,
                  f"variants {tag}: launches by span {chained}")
            fold = os.path.join(exp, "f0")
            with open(os.path.join(fold, "history.csv")) as fh:
                rows = list(csv.DictReader(fh))
            check(len(rows) == 2 and all(
                np.isfinite(float(r[k])) for r in rows
                for k in ("loss", "val_loss")),
                f"variants {tag}: history {rows}")
            _check_predictions(fold, test, seg=heads > 1)
            t0 = time.perf_counter()
            evaluate_main(["-exp", exp, "-data", data_root])
            evaluate_s = time.perf_counter() - t0
            with open(os.path.join(exp, "df_eval.csv"), newline="") as fh:
                df = list(csv.DictReader(fh))
            check(len(df) == phases, f"variants {tag}: {len(df)} rows")
            dists = [float(r[c] or "nan") for r in df
                     for c in ("mdists_ant_gtpred", "mdists_inf_gtpred")]
            seg_dice = {}
            if heads > 1:
                for c in ("seg_dice_rv", "seg_dice_myo", "seg_dice_lv"):
                    check(c in df[0] and all(r[c] for r in df),
                          f"variants {tag}: column {c} missing or empty")
                    seg_dice[c] = [float(r[c]) for r in df]
            timing = _time_steps(cfg, data_root)
            log("variant", template=name, train_wall_s=wall_s,
                k1_launches=k1, k2_launches=k2, train_steps=2 * (
                    6 * 2 * Z // batch),
                flagship_gn_step_ms_median=flagship_timing["step_ms_median"],
                pred_fold_wall_s=chained["wall_s"],
                pred_fold_ms_per_patient_phase=_ms_per_phase(
                    chained["phases"]),
                evaluate_cv_s=evaluate_s, mdists_gtpred_mm=dists,
                seg_dice=seg_dice, history=[
                    {k: float(r[k]) for k in ("loss", "val_loss")}
                    for r in rows], **timing)
            by_path[f"{tag}:train"] = {"k1": chained["k1_before"],
                                       "k2": chained["k2_before"]}
            by_path[f"{tag}:pred_fold"] = {"k1": chained["k1"],
                                           "k2": chained["k2"]}
            if heads > 1:  # serve the multihead fold before work goes
                # the serve sets every count to 0: the 2D paths so far
                # launched no 3D kernel
                check(kernels.converge_labels_3d_cuda.launches == 0,
                      "variants: the 3D CC kernel launched on a 2D path")
                by_path["serve_multihead"] = _serve_fold(
                    fold, os.path.join(work, "serve"), "serve-multihead",
                    {"msk": {0, 1, 2}, "seg": {0, 1, 2, 3}})
    check("serve_multihead" in by_path, "variants: no multihead fold served")
    check(not _loaded_foreign(), f"variants: loaded {_loaded_foreign()}")
    return by_path


# -- the one-card trainer's remaining features ------------------------------

# optimizers: the rules on the card against the CPU from the same weights
# and batch, f32 and TF32 off, ELU (PERF.md: with ReLU at a random init the
# f32 gradient lies 1-16% of max |g| from float64 on any device). SAME_GRAD:
# the card's update from the CPU's weights and gradients, per parameter, x
# max |update|: the same float32 arithmetic in another order and with
# CUDA's rsqrt (the weights' own change is no yardstick here: a 1e-4 step
# of a weight near 1 is a few hundred float32 ulps, and one ulp of rounding
# then reads as 1e-2; measured on an H100 (700 W) so: up to 7.8e-3).
# FULL_STEP: 3 whole steps, each device with its own gradients, the
# relative L2 norm of the difference of the changes over all parameters:
# measured on an H100 (700 W) 1.3e-4 (rmsprop) to 7.6e-4 (nadam)
OPT_CASES = {"adam": {}, "nadam": {}, "sgd": {}, "adagrad": {},
             "rmsprop": {}, "adadelta": {}, "radam": {},
             "adam+agc": {"OPTIMIZER": "adam", "AGC": 0.08}}
OPT_SAME_GRAD_ATOL = 1e-5
OPT_FULL_STEP_RTOL = 5e-3
# resume-exact: B's rows after its restore point against A's, relative, on
# the train loss, which reads the restored random streams at once (the
# eval columns see them only through the weights). cuDNN's backward is not
# bit-deterministic: measured on an H100 (700 W) the resumed run lay 4.1e-5
# from the straight one (2.7e-6 in the epoch before the restore, which
# both computed alike), and a control resumed without its generators'
# states 3.6e-3 (PERF.md)
RESUME_EXACT_RTOL = 5e-4
RESUME_EXACT_KEYS = ("loss",)
# cache-dtype. DECODE: each image value gathered from the card's cache
# against the float32 image, over half a step of its storage (half a
# bf16 ulp; half a level of the example's uint8 range): round to nearest
# reads at most 1 (uint8 up to 1 + 2e-4 from float32 arithmetic), a
# truncating bf16 cache up to 2, 4-bit image levels 17. LOSS: one epoch's
# mean loss against the float32 cache's, relative, computed in float32
# with TF32 off: in bf16 the model's own rounding lifts every cache's
# reading to ~1e-4 (a CPU rehearsal at 64², depth 3: sound 4.8e-5-8.6e-5,
# the 4-bit control 4.6e-4). Measured in float32 on an H100 (700 W): bf16
# 2.2e-5, uint8 3.9e-5, the truncating bf16 cache 3.5e-5 (caught by DECODE
# alone), the 4-bit control 4.9e-3 (PERF.md)
CACHE_DECODE_MAX = 1.001
CACHE_LOSS_RTOL = 3e-4


class _patched:
    """Replace ``owner.name`` by ``fn(original)`` inside a with-block."""

    def __init__(self, owner, name, wrap):
        self.owner, self.name, self.wrap = owner, name, wrap

    def __enter__(self):
        self.orig = getattr(self.owner, self.name)
        setattr(self.owner, self.name, self.wrap(self.orig))

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def _files(root):
    """Every file under ``root``: (mtime, bytes)."""
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            path = os.path.join(d, name)
            with open(path, "rb") as fh:
                out[path] = (os.path.getmtime(path), fh.read())
    return out


def _rows(fold):
    with open(os.path.join(fold, "history.csv")) as fh:
        return list(csv.DictReader(fh))


def _lines(fold):
    with open(os.path.join(fold, "history.csv")) as fh:
        return fh.read().splitlines()


def _on_host(tree):
    """A host copy of every tensor of ``tree`` (a copy on the CPU too: the
    next step updates the live tensors in place)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _on_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on_host(v) for v in tree)
    return tree


def _diff_paths(a, b, path=""):
    """Paths where two host trees differ (tensors bit for bit)."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        same = isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) \
            and a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        return [] if same else [path]
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{path} keys"]
        return [p for k in a for p in _diff_paths(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{path} length"]
        return [p for i, (x, y) in enumerate(zip(a, b))
                for p in _diff_paths(x, y, f"{path}/{i}")]
    return [] if a == b else [path]


def _epoch_launches(cfg):
    """K1 launches of one epoch of the cohort's fold 0: one per train step
    and one per eval step (the remainder batch included)."""
    batch = int(cfg["BATCHSIZE"])
    return 6 * 2 * Z // batch + -(-(2 * 2 * Z) // batch)


def _steps_per_epoch(cfg):
    return 6 * 2 * Z // int(cfg["BATCHSIZE"])


def _sample_launches(cfg, n_train=6 * 2 * Z, n_val=2 * 2 * Z):
    """K1 launches of train_fold's sample batches for the ImageWriter,
    drawn whatever the SAVE flags say: batch 0 of the train and of the val
    generator, each finalized once where both hold a full batch; with GAUS
    one launch a batch (one per sigmoid head with HEADS), else none."""
    batch = int(cfg["BATCHSIZE"])
    if not cfg.get("GAUS") or n_train < batch or n_val < batch:
        return 0
    heads = cfg.get("HEADS") or ()
    return 2 * (sum(str(h[2]) != "softmax" for h in heads) if heads else 1)


def _save_ms(cfg, model_dir, reps=5):
    """A full-state ModelCheckpoint save of the flagship trainer after one
    step: synchronous (host clock, the files on disk), and the async
    submit's cost to the loop (host clock of the call, and CUDA events
    around the on-card snapshot it queues); then the flush."""
    from cmrtpu_torch.train.callbacks import ModelCheckpoint
    trainer = Trainer(cfg, device="cuda")
    rng = np.random.default_rng(SEED + 3)
    x, y = finalize_batch(torch.from_numpy(_phantom(rng, 16, H, W)),
                          torch.zeros(16, H, W), cfg)
    trainer.state.train_step(x.cuda(), y.cuda())
    out = {}
    for mode in ("sync", "async"):
        cb = ModelCheckpoint(os.path.join(model_dir, mode),
                             async_write=mode == "async")
        host, device, flush = [], [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            cb._save(trainer)
            end.record()
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            device.append(start.elapsed_time(end))
            t0 = time.perf_counter()
            cb.on_train_end(trainer)
            flush.append((time.perf_counter() - t0) * 1e3)
        out[mode] = {"host_ms_median": float(np.median(host)),
                     "device_ms_median": float(np.median(device)),
                     "flush_ms_median": float(np.median(flush))}
    out["state_bytes"] = os.path.getsize(os.path.join(
        model_dir, "sync", "state.pt"))
    return out


def phase_resume(cfg, data_root, work):
    """cli.train with EPOCHS 2, then cli.train -resume with EPOCHS 4: the
    restored state equals the one saved at the best epoch bit for bit, the
    history keeps the first run's rows before the restore point byte for
    byte and holds epochs 0-3, fold_complete.json targets 4, and the
    kernels launch exactly once per sample batch (drawn before the
    restore), train and eval step retrained and patient-phase; a third
    call with the same EPOCHS skips the fold: no
    launch, no file changed. Then the ms of a full-state save."""
    cfg = dict(cfg, EPOCHS=2, FOLDS=[0])
    exp, k1, k2, chained, _ = _train_cli(cfg, data_root, work, "resume")
    fold = os.path.join(exp, "f0")
    per_epoch, samples = _epoch_launches(cfg), _sample_launches(cfg)
    check(k1 == samples + 2 * per_epoch + 4 and k2 == 4,
          f"resume: first run K1 {k1}, K2 {k2}")
    model_dir = os.path.join(fold, "model")
    saved = torch.load(os.path.join(model_dir, "state.pt"),
                       map_location="cpu", weights_only=True)
    first = _lines(fold)
    restored = []

    def capture(orig):
        def restore(self, ckpt_dir):
            step = orig(self, ckpt_dir)
            restored.append(_on_host(self.train_state()))
            return step
        return restore

    with _patched(Trainer, "restore", capture):
        _, r_k1, r_k2, r_chained, wall_s = _train_cli(
            dict(cfg, EPOCHS=4), data_root, work, "resume4",
            ["-resume", exp])
    check(len(restored) == 1, f"resume: {len(restored)} restores")
    diff = _diff_paths(restored[0], saved)
    check(not diff, f"resume: the restored state differs from the saved "
          f"one at {diff[:8]}")
    restore_epoch = saved["step"] // _steps_per_epoch(cfg)
    retrained = 4 - restore_epoch
    check(1 <= restore_epoch <= 2, f"resume: restore epoch {restore_epoch}")
    rows = _rows(fold)
    check([int(r["epoch"]) for r in rows] == [0, 1, 2, 3],
          f"resume: history epochs {[r['epoch'] for r in rows]}")
    check(_lines(fold)[:1 + restore_epoch] == first[:1 + restore_epoch],
          "resume: the rows before the restore point changed")
    with open(os.path.join(fold, "fold_complete.json")) as fh:
        marker = json.load(fh)
    check(marker["epochs_target"] == 4, f"resume: marker {marker}")
    # the sample batches are drawn before the restore
    want = samples + per_epoch * retrained + 4
    check(r_k1 == want and r_k2 == 4
          and r_chained["k1"] == r_chained["k2"] == 4,
          f"resume: K1 {r_k1} (want {want}), K2 {r_k2}")
    before = _files(exp)
    _, s_k1, s_k2, _, _ = _train_cli(dict(cfg, EPOCHS=4), data_root, work,
                                     "resume-skip", ["-resume", exp],
                                     spans=False)
    check(s_k1 == s_k2 == 0, f"resume: the skipped fold launched K1 {s_k1}, "
          f"K2 {s_k2}")
    check(_files(exp) == before, "resume: the skipped call changed a file")
    save = _save_ms(cfg, os.path.join(work, "save_timing"))
    log("resume", restored_step=saved["step"], restore_epoch=restore_epoch,
        epochs_retrained=retrained, resumed_wall_s=wall_s,
        launches={"first": [k1, k2], "resumed": [r_k1, r_k2],
                  "skipped": [s_k1, s_k2]},
        history=[{k: float(r[k]) for k in ("loss", "val_loss", "lr")}
                 for r in rows], full_state_save=save)
    return {"resume:first": {"k1": k1, "k2": k2},
            "resume:resumed": {"k1": r_k1, "k2": r_k2},
            "resume:skipped": {"k1": s_k1, "k2": s_k2}}


def _max_rel(rows_a, rows_b, keys):
    worst = 0.0
    for a, b in zip(rows_a, rows_b):
        for k in keys:
            x, y = float(a[k]), float(b[k])
            worst = max(worst, abs(x - y) / max(abs(y), 1e-12))
    return worst


def phase_resume_exact(cfg, data_root, work):
    """float32, SHUFFLE false, augmentation and dropout on: run A trains 3
    epochs straight; run B trains 2, then resumes to 3; run C is B's
    2-epoch run resumed without its generators' states (reseeded). B's
    rows from its restore point on lie within RESUME_EXACT_RTOL of A's; C's
    must not."""
    # an EXPERIMENT each: run dirs are stamped to the minute
    cfg = dict(cfg, MIXED_PRECISION=False, SHUFFLE=False, FOLDS=[0])
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        exp_a, a_k1, a_k2, _, _ = _train_cli(
            dict(cfg, EPOCHS=3, EXPERIMENT="exact_a"), data_root, work,
            "exact_a")
        cfg = dict(cfg, EXPERIMENT="exact_b")
        exp_b, _, _, _, _ = _train_cli(dict(cfg, EPOCHS=2), data_root, work,
                                       "exact_b")
        exp_c = exp_b + "_control"
        shutil.copytree(exp_b, exp_c)
        step = torch.load(os.path.join(exp_b, "f0", "model", "state.pt"),
                          map_location="cpu", weights_only=True)["step"]
        restore_epoch = step // _steps_per_epoch(cfg)
        _, b_k1, b_k2, _, _ = _train_cli(dict(cfg, EPOCHS=3), data_root, work,
                                         "exact_b3", ["-resume", exp_b])

        def forget(orig):
            def restore(self, ckpt_dir):
                out = orig(self, ckpt_dir)
                seed = int(self.config.get("SEED", 42))
                self.generator.manual_seed(seed)
                self.loop_generator.manual_seed(seed + 1)
                return out
            return restore

        with _patched(Trainer, "restore", forget):
            _train_cli(dict(cfg, EPOCHS=3), data_root, work, "exact_c3",
                       ["-resume", exp_c])
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    rows = {name: _rows(os.path.join(exp, "f0")) for name, exp in
            (("a", exp_a), ("b", exp_b), ("c", exp_c))}
    check(all(len(r) == 3 for r in rows.values()),
          f"resume-exact: history lengths {[len(r) for r in rows.values()]}")
    b_err = _max_rel(rows["b"][restore_epoch:], rows["a"][restore_epoch:],
                     RESUME_EXACT_KEYS)
    b_before = _max_rel(rows["b"][:restore_epoch], rows["a"][:restore_epoch],
                        RESUME_EXACT_KEYS)
    c_err = _max_rel(rows["c"][restore_epoch:], rows["a"][restore_epoch:],
                     RESUME_EXACT_KEYS)
    per_epoch = _epoch_launches(cfg)
    log("resume-exact", restore_epoch=restore_epoch, rtol=RESUME_EXACT_RTOL,
        resumed_vs_straight_max_rel=b_err,
        before_restore_vs_straight_max_rel=b_before,
        control_no_generators_max_rel=c_err, keys=RESUME_EXACT_KEYS,
        val_loss_resumed_vs_straight_max_rel=_max_rel(
            rows["b"][restore_epoch:], rows["a"][restore_epoch:],
            ("val_loss",)),
        loss={k: [float(r["loss"]) for r in v] for k, v in rows.items()},
        val_loss={k: [float(r["val_loss"]) for r in v]
                  for k, v in rows.items()})
    samples = _sample_launches(cfg)
    check(a_k1 == samples + 3 * per_epoch + 4 and a_k2 == 4 and
          b_k1 == samples + (3 - restore_epoch) * per_epoch + 4
          and b_k2 == 4,
          f"resume-exact: K1 {a_k1} straight, {b_k1} resumed; K2 {a_k2} "
          f"straight, {b_k2} resumed")
    check(b_err <= RESUME_EXACT_RTOL,
          f"resume-exact: the resumed rows lie {b_err} from the straight "
          f"run's (bound {RESUME_EXACT_RTOL})")
    check(c_err > RESUME_EXACT_RTOL,
          f"resume-exact: the control without generator states lies only "
          f"{c_err} from the straight run: the bound cannot tell")
    return {"resume_exact:straight": {"k1": a_k1, "k2": a_k2},
            "resume_exact:resumed": {"k1": b_k1, "k2": b_k2}}


def _warm_step_ms(step, reps=12, warm=3):
    """Median ms of ``step()`` by CUDA events, after warm calls."""
    for _ in range(warm):
        step()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _loop(cfg, gen):
    trainer = Trainer(cfg, device="cuda")
    loop = DeviceCachedLoop(trainer, gen)
    idx = torch.from_numpy(loop._epoch_indices(loop.n_train, False)).cuda()
    return loop, idx


def phase_ema(cfg, data_root, work, gen):
    """A 2-epoch flagship fold with EMA true through cli.train: model.npz
    holds the shadow of the state saved beside it bit for bit (and not the
    live weights), the chained pred_fold runs from it with one launch of
    each kernel per patient-phase; then the warm step with and without
    EMA."""
    from cmrtpu_torch.train.checkpoint import flax_to_state_dict, load_weights
    ema_cfg = dict(cfg, EMA=True, EPOCHS=2, FOLDS=[0], EXPERIMENT="ema")
    exp, k1, k2, chained, wall_s = _train_cli(ema_cfg, data_root, work, "ema")
    model_dir = os.path.join(exp, "f0", "model")
    state = torch.load(os.path.join(model_dir, "state.pt"),
                       map_location="cpu", weights_only=True)
    npz = flax_to_state_dict(*load_weights(model_dir))
    check(state["ema"] is not None and set(state["ema"]) <= set(npz),
          "ema: no shadow in the saved state")
    bad = [n for n, t in state["ema"].items() if not torch.equal(npz[n], t)]
    check(not bad, f"ema: model.npz differs from the shadow at {bad[:5]}")
    check(any(not torch.equal(state["model"][n], t)
              for n, t in state["ema"].items()),
          "ema: the shadow equals the live weights")
    check(chained["k1"] == chained["k2"] == 4
          and k1 == _sample_launches(cfg) + 2 * _epoch_launches(cfg) + 4
          and k2 == 4,
          f"ema: K1 {k1}, K2 {k2}, pred_fold {chained}")
    times = {}
    for name, c in (("ema", ema_cfg), ("no_ema", cfg)):
        loop, idx = _loop(c, gen)
        i = iter(range(10 ** 6))
        times[name] = _warm_step_ms(
            lambda: loop.train_step(idx[next(i) % len(idx)]))
    log("ema", wall_s=wall_s, k1_launches=k1, k2_launches=k2,
        pred_fold_launches=[chained["k1"], chained["k2"]],
        shadow_tensors=len(state["ema"]), step_ms_median=times,
        history=[{k: float(r[k]) for k in ("loss", "val_loss")}
                 for r in _rows(os.path.join(exp, "f0"))])
    return {"ema:train": {"k1": chained["k1_before"],
                          "k2": chained["k2_before"]},
            "ema:pred_fold": {"k1": chained["k1"], "k2": chained["k2"]}}


def _truncating_bf16(pack):
    """Control: a bf16 cache that drops the low 16 bits (no rounding)."""
    def truncated(x, y, config):
        xt, yt = pack(x, y, config)
        bits = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
        bits = bits.view(torch.int32) & -65536
        return bits.view(torch.float32).to(torch.bfloat16), yt
    return truncated


def _four_bit(quantize):
    """Control: uint8 images on 16 levels (0, 17, ..., 255)."""
    return lambda imgs: (np.rint(quantize(imgs) / 17.0) * 17).astype(
        np.uint8)


def _decode_error(loop, x_ref, y_ref):
    """The cache gathered on the card against the float32 images, over
    half a step of its storage (CACHE_DECODE_MAX); masks must be exact."""
    idx = torch.arange(loop.n_train, device=loop.x_train.device)
    imgs, msks = loop._gather(loop.x_train, loop.y_train, idx)
    if loop.x_train.dtype == torch.uint8:
        flat = x_ref.reshape(x_ref.shape[0], -1).double()
        lo = flat.min(1, keepdim=True).values
        span = (flat.max(1, keepdim=True).values - lo).clamp(
            min=float(np.finfo(np.float32).tiny))
        err = (imgs.reshape(flat.shape).double()
               - (flat - lo) / span * 255.0).abs() / 0.5
    elif loop.x_train.dtype == torch.bfloat16:
        _, e = torch.frexp(x_ref)  # |x| in [2**(e-1), 2**e): ulp 2**(e-8)
        half = torch.ldexp(torch.ones_like(x_ref), e - 9)
        err = (imgs - x_ref).abs() / half
    else:
        err = (imgs - x_ref).abs()
    return float(err.max()), bool(torch.equal(msks, y_ref))


def phase_cache_dtype(cfg, gen):
    """The flagship's device-resident loop from a float32, a bfloat16 and a
    uint8 image cache (masks uint8 in all three), the same weights and
    random streams: the cache's bytes on the card, the cache gathered on
    the card against the float32 images (within CACHE_DECODE_MAX), one
    epoch's mean loss in float32 (within CACHE_LOSS_RTOL of the float32
    cache's) and the flagship's warm bf16 step. Controls: a truncating
    bf16 cache must fail the decode bound, a 4-bit uint8 cache both
    bounds."""
    x_ref = torch.from_numpy(gen._cache_x).cuda()
    y_ref = torch.from_numpy(gen._cache_y).cuda()
    f32_cfg = dict(cfg, MIXED_PRECISION=False)
    out = {}
    cases = (("float32", "float32", None), ("bfloat16", "bfloat16", None),
             ("uint8", "uint8", None),
             ("control_bf16_truncated", "bfloat16",
              ("pack_arrays", _truncating_bf16)),
             ("control_uint8_4bit", "uint8",
              ("quantize_images_uint8", _four_bit)))
    for name, dtype, fault in cases:
        with _patched(device_cache, *fault) if fault else \
                contextlib.nullcontext():
            loop, idx = _loop(dict(f32_cfg, CACHE_DTYPE=dtype), gen)
        nbytes = {key: t.numel() * t.element_size() for key, t in
                  (("images", loop.x_train), ("masks", loop.y_train))}
        check(loop.y_train.dtype == torch.uint8,
              f"cache-dtype: masks stored as {loop.y_train.dtype}")
        decode, masks_exact = _decode_error(loop, x_ref, y_ref)
        with _tf32_off():
            loss = loop.run_train_epoch()["loss"]
        r = out[name] = {"bytes": nbytes,
                         "images_dtype": str(loop.x_train.dtype),
                         "decode_over_half_step": decode,
                         "masks_exact": masks_exact, "epoch_loss": loss}
        if fault is None:
            loop, idx = _loop(dict(cfg, CACHE_DTYPE=dtype), gen)
            i = iter(range(10 ** 6))
            r["bf16_step_ms_median"] = _warm_step_ms(
                lambda: loop.train_step(idx[next(i) % len(idx)]))
        del loop, idx
    f32 = out["float32"]
    for r in out.values():
        r["loss_rel_to_float32"] = abs(r["epoch_loss"] - f32["epoch_loss"]) \
            / abs(f32["epoch_loss"])
    log("cache-dtype", decode_max=CACHE_DECODE_MAX,
        loss_rtol=CACHE_LOSS_RTOL, **out)
    n = f32["bytes"]["images"]
    check(out["bfloat16"]["bytes"]["images"] * 2 == n
          and out["uint8"]["bytes"]["images"] * 4 == n,
          f"cache-dtype: bytes {[r['bytes'] for r in out.values()]}")
    check(all(r["masks_exact"] for r in out.values()),
          "cache-dtype: a mask cache does not read back exactly")
    check(f32["decode_over_half_step"] == 0.0,
          "cache-dtype: the float32 cache does not read back exactly")
    for name in ("bfloat16", "uint8"):
        r = out[name]
        check(r["decode_over_half_step"] <= CACHE_DECODE_MAX,
              f"cache-dtype: {name} reads back {r['decode_over_half_step']} "
              f"half steps from the float32 images")
        check(r["loss_rel_to_float32"] <= CACHE_LOSS_RTOL,
              f"cache-dtype: {name} epoch loss {r['epoch_loss']} "
              f"vs float32 {f32['epoch_loss']}")
    for name in ("control_bf16_truncated", "control_uint8_4bit"):
        check(out[name]["decode_over_half_step"] > CACHE_DECODE_MAX,
              f"cache-dtype: {name} reads back within the decode bound")
    check(out["control_uint8_4bit"]["loss_rel_to_float32"] > CACHE_LOSS_RTOL,
          "cache-dtype: the 4-bit control's epoch loss lies within "
          f"{CACHE_LOSS_RTOL} of the float32 cache's: the bound cannot tell")


def _changes(trainer, start):
    return {n: (p.detach().double().cpu() - start[n].double())
            for n, p in trainer.model.named_parameters()}


def phase_optimizers(cfg):
    """Each rule (and adam with AGC 0.08) for 3 f32 steps of the flagship
    net (ELU) at batch 2 on the card and on the CPU from the same weights
    and batch. Same gradients: at each step a rule on the card and one on
    the CPU, fed the CPU trainer's weights and gradients, give updates
    within OPT_SAME_GRAD_ATOL x max |update| per parameter. Whole steps:
    each device with its own gradients, the changes within
    OPT_FULL_STEP_RTOL (relative L2 over all parameters). Then the warm
    bf16 step at batch 16 of each, beside adam's."""
    base = dict(cfg, MIXED_PRECISION=False, DROPOUT_MIN=0.0, DROPOUT_MAX=0.0,
                AUGMENT=False, ACTIVATION="elu", BATCHSIZE=2)
    rng = np.random.default_rng(SEED + 4)
    msks = np.zeros((2, H, W), np.float32)
    msks[0, 60:64, 120:124], msks[0, 100:104, 116:120] = 1, 2
    x, y = finalize_batch(torch.from_numpy(_phantom(rng, 2, H, W)),
                          torch.from_numpy(msks), base)
    weights = init_model(base).state_dict()
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    results = {}
    try:
        for name, extra in OPT_CASES.items():
            c = dict(base, **({"OPTIMIZER": name} if not extra else extra))
            cpu, card = Trainer(c, device="cpu"), Trainer(c, device="cuda")
            for t in (cpu, card):
                t.model.load_state_dict(weights)
            names = [n for n, _ in cpu.model.named_parameters()]
            mirrors = {"cpu": [torch.nn.Parameter(p.detach().clone())
                               for p in cpu.model.parameters()]}
            mirrors["cuda"] = [torch.nn.Parameter(p.detach().clone().cuda())
                               for p in mirrors["cpu"]]
            rules = {d: get_optimizer(list(zip(names, mirrors[d])), c)
                     for d in mirrors}
            same = 0.0
            for _ in range(3):
                with torch.no_grad():
                    for d, ps in mirrors.items():
                        for p, q in zip(ps, cpu.model.parameters()):
                            p.copy_(q)
                cpu.state.train_step(x, y)
                card.state.train_step(x.cuda(), y.cuda())
                grads = [q.grad for q in cpu.model.parameters()]
                u_cpu = rules["cpu"].updates(mirrors["cpu"], grads)
                u_card = rules["cuda"].updates(mirrors["cuda"],
                                               [g.cuda() for g in grads])
                same = max(same, max(
                    float((b.cpu() - a).abs().max())
                    / (float(a.abs().max()) or 1.0)
                    for a, b in zip(u_cpu, u_card)))
            d_cpu, d_card = (_changes(t, weights) for t in (cpu, card))
            num = sum(float(((d_card[n] - d) ** 2).sum())
                      for n, d in d_cpu.items())
            den = sum(float((d ** 2).sum()) for d in d_cpu.values())
            results[name] = {"same_grad_max": same,
                             "full_step_rel_l2": (num / den) ** 0.5,
                             "rule": card.optimizer_name}
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    x16, y16 = finalize_batch(
        torch.from_numpy(_phantom(rng, 16, H, W)),
        torch.from_numpy(np.repeat(msks[:1], 16, 0)), cfg)
    x16, y16 = x16.cuda(), y16.cuda()
    for name, extra in OPT_CASES.items():
        trainer = Trainer(dict(cfg, **({"OPTIMIZER": name} if not extra
                                       else extra)), device="cuda")
        results[name]["bf16_step_ms_batch16"] = _warm_step_ms(
            lambda: trainer.state.train_step(x16, y16))
    adam_ms = results["adam"]["bf16_step_ms_batch16"]
    for r in results.values():
        r["step_vs_adam"] = r["bf16_step_ms_batch16"] / adam_ms
    log("optimizers", same_grad_atol=OPT_SAME_GRAD_ATOL,
        full_step_rtol=OPT_FULL_STEP_RTOL, **results)
    for name, r in results.items():
        check(r["same_grad_max"] <= OPT_SAME_GRAD_ATOL,
              f"optimizers {name}: the card's update from the CPU's weights "
              f"and gradients lies {r['same_grad_max']} x max |update| "
              "from the CPU's")
        check(r["full_step_rel_l2"] <= OPT_FULL_STEP_RTOL,
              f"optimizers {name}: 3 steps on the card lie "
              f"{r['full_step_rel_l2']} (relative L2) from the CPU's")


def phase_trainer_features(cfg, flagship_timing, card):
    """resume, resume-exact, ema, cache-dtype, supervision, sharded-cache
    and stream on one phantom cohort at the flagship's widths. Returns the
    kernels' launches by path."""
    by_path = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as work:
        data_root = os.path.join(work, "data")
        _make_dataset(data_root)
        by_path.update(phase_resume(cfg, data_root, work))
        by_path.update(phase_resume_exact(cfg, data_root, work))
        x_tr, y_tr, x_val, y_val = get_trainings_files(
            os.path.join(data_root, "2D"), 0,
            os.path.join(data_root, "df_kfold.csv"))
        gen = DataGenerator(x_tr, y_tr, config=cfg)
        by_path.update(phase_ema(cfg, data_root, work, gen))
        phase_cache_dtype(cfg, gen)
        by_path.update(phase_supervision(
            cfg, work, gen, DataGenerator(x_val, y_val, config=cfg)))
        by_path.update(phase_surface(
            cfg, work, gen, DataGenerator(x_val, y_val, config=cfg)))
        by_path.update(phase_sharded_cache(data_root, work, gen,
                                           flagship_timing, card))
        by_path.update(phase_stream(cfg, data_root, work, card))
        by_path.update(phase_distributed(cfg, data_root, work, gen, card))
    check(not _loaded_foreign(), f"trainer: loaded {_loaded_foreign()}")
    return by_path


# -- slice 6: the sharded cache on one card and host streaming --------------

SHARDED_TEMPLATE = os.path.join(TEMPLATES, "sharded_cache_config.json")
# stream: one streamed epoch against one device-cached epoch from the same
# weights, data order and draws (SHUFFLE false, bf16 storage), as the
# relative L2 norm of the difference of the parameters' changes over the
# norm of the cached epoch's change. Measured on an H100 (700 W) 9.0e-5
# (cuDNN's weight-gradient reductions reorder; on the CPU 0), the control
# with batch 0's images perturbed 0.86 (PERF.md): the bound keeps ~11x over
# the reading
STREAM_PARITY_RTOL = 1e-3
# the control's perturbation: noise of this std on batch 0's images (MinMax
# images lie in [0, 1])
STREAM_CONTROL_NOISE = 0.05


def _cohort_steps(batch):
    """(train steps, full eval batches, eval batches with the remainder)
    of one epoch of the phantom cohort's fold 0 (6 + 2 patients x 2
    frames x Z slices)."""
    n_train, n_val = 6 * 2 * Z, 2 * 2 * Z
    return n_train // batch, n_val // batch, -(-n_val // batch)


def _cli_launch_checks(tag, k1, k2, chained, per_fold, phases):
    """K1 ``per_fold`` times before the chained pred_fold (the sample
    batches and the fit's steps) and once per patient-phase in it, K2 once
    per patient-phase, the 3D kernel never. Returns the two paths'
    launches."""
    check(chained["k1_before"] == per_fold and chained["k2_before"] == 0
          and chained["k1"] == chained["k2"] == phases
          and k1 == per_fold + phases and k2 == phases,
          f"{tag}: K1 {k1}, K2 {k2} (spans {chained}); want K1 {per_fold} "
          f"+ {phases}, K2 {phases}")
    check(kernels.converge_labels_3d_cuda.launches == 0,
          f"{tag}: the 3D CC kernel launched")
    return {f"{tag}:train": {"k1": chained["k1_before"],
                             "k2": chained["k2_before"]},
            f"{tag}:pred_fold": {"k1": chained["k1"], "k2": chained["k2"]}}


def _history_rows(fold, epochs):
    with open(os.path.join(fold, "history.csv")) as fh:
        rows = list(csv.DictReader(fh))
    check(len(rows) == epochs and all(
        np.isfinite(float(r[k])) for r in rows for k in ("loss", "val_loss")),
        f"{fold}: history {rows}")
    return [{k: float(r[k]) for k in ("loss", "val_loss")} for r in rows]


def _grads_bf16(cfg, gen):
    """Whether every gradient the optimizer rule read in one step of the
    cached loop is bfloat16-representable, and a function taking the
    loop's next step."""
    loop, idx = _loop(cfg, gen)
    loop.train_step(idx[0])
    representable = all(torch.equal(p.grad, p.grad.bfloat16().float())
                        for p in loop.trainer.model.parameters())
    i = iter(range(10 ** 6))
    return representable, lambda: loop.train_step(idx[next(i) % len(idx)])


def _paired_step_ms(name_a, step_a, name_b, step_b, rounds=6, reps=8):
    """Interleaved warm-step medians of two steps, ABBA order, ``reps``
    timed steps an arm a round: each arm's per-round medians and the
    per-round differences a - b, resolved when every round's difference
    has one sign."""
    ms = {name_a: [], name_b: []}
    order = ((name_a, step_a), (name_b, step_b))
    for r in range(rounds):
        for name, step in (order if r % 2 == 0 else order[::-1]):
            ms[name].append(_warm_step_ms(step, reps=reps, warm=1))
    diffs = [a - b for a, b in zip(ms[name_a], ms[name_b])]
    out = {f"{name}_ms": v for name, v in ms.items()}
    out.update({f"{name}_ms_median": float(np.median(v))
                for name, v in ms.items()})
    return dict(out, diff_ms=diffs, diff_ms_median=float(np.median(diffs)),
                resolved=all(d > 0 for d in diffs)
                or all(d < 0 for d in diffs))


def phase_sharded_cache(data_root, work, gen, flagship_timing, card):
    """sharded_cache_config.json at its widths (BatchNorm, bf16, CACHE_DTYPE
    bfloat16, CACHE_SHARDED, GRAD_ALLREDUCE_DTYPE bfloat16), EPOCHS 2,
    through cli.train (chained pred_fold) and cli.evaluate_cv: K1 once per
    sample batch, train step, eval batch (the remainder's too) and
    patient-phase,
    K2 once per patient-phase. Then in process: every gradient the rule
    reads is bf16-representable (the control without the key is not);
    with CACHE_RESHUFFLE_EPOCHS 1 the caches on the card after the
    reshuffle equal the packed host caches permuted by the loop rng's own
    draws, byte for byte (the control, the unpermuted cache, differs); the
    step with and without the cast in interleaved rounds; the warm step
    beside the flagship's."""
    with open(SHARDED_TEMPLATE, encoding="utf-8") as fh:
        cfg = dict(json.load(fh), EPOCHS=2, FOLDS=[0])
    exp, k1, k2, chained, wall_s = _train_cli(cfg, data_root, work,
                                              "sharded")
    batch = int(cfg["BATCHSIZE"])
    train_steps, _, eval_steps = _cohort_steps(batch)
    test = fold_patients(os.path.join(data_root, "df_kfold.csv"), 0)
    phases = 2 * len(test)
    paths = _cli_launch_checks(
        "sharded", k1, k2, chained,
        _sample_launches(cfg) + 2 * (train_steps + eval_steps), phases)
    fold = os.path.join(exp, "f0")
    history = _history_rows(fold, 2)
    _check_predictions(fold, test)
    t0 = time.perf_counter()
    evaluate_main(["-exp", exp, "-data", data_root])
    evaluate_s = time.perf_counter() - t0
    with open(os.path.join(exp, "df_eval.csv"), newline="") as fh:
        df = list(csv.DictReader(fh))
    dists = [float(r[c] or "nan") for r in df
             for c in ("mdists_ant_gtpred", "mdists_inf_gtpred")]
    check(len(df) == phases and np.isfinite(dists).any(),
          f"sharded: df_eval {len(df)} rows, distances {dists}")

    grads_bf16, cast_step = _grads_bf16(cfg, gen)
    control_bf16, uncast_step = _grads_bf16(
        {k: v for k, v in cfg.items() if k != "GRAD_ALLREDUCE_DTYPE"}, gen)
    check(grads_bf16 and not control_bf16,
          f"sharded: gradients bf16-representable {grads_bf16}, without "
          f"GRAD_ALLREDUCE_DTYPE {control_bf16}")
    cast = _paired_step_ms("with_cast", cast_step, "without_cast",
                           uncast_step)
    del cast_step, uncast_step

    rcfg = dict(cfg, CACHE_RESHUFFLE_EPOCHS=1)
    loop = DeviceCachedLoop(Trainer(rcfg, device="cuda"), gen)
    n = loop.n_train
    # the reshuffle comes before the second epoch's indices
    for _ in range(2):
        loop.run_train_epoch()
    draws = np.random.default_rng(int(cfg["SEED"]))
    draws.permutation(n)
    perm = torch.from_numpy(draws.permutation(n))
    host_x, host_y = device_cache.pack_arrays(gen._cache_x, gen._cache_y,
                                              rcfg)
    card_x, card_y = loop.x_train.cpu(), loop.y_train.cpu()
    reshuffled = (card_x.dtype == torch.bfloat16
                  and torch.equal(card_x, host_x[perm])
                  and torch.equal(card_y, host_y[perm]))
    unpermuted = torch.equal(card_x, host_x)
    check(reshuffled and not unpermuted,
          f"sharded: the reshuffled cache equals the host cache under the "
          f"rng's permutation: {reshuffled}; unpermuted: {unpermuted}")
    del loop

    timing = _time_loop(DeviceCachedLoop(Trainer(cfg, device="cuda"), gen))
    log("sharded-cache", card=card, train_steps=2 * train_steps,
        eval_steps=2 * eval_steps, k1_launches=k1, k2_launches=k2,
        train_wall_s=wall_s, pred_fold_wall_s=chained["wall_s"],
        evaluate_cv_s=evaluate_s, mdists_gtpred_mm=dists, history=history,
        grads_bf16=grads_bf16, control_grads_bf16=control_bf16,
        cast_step_ms_paired=cast,
        reshuffled_rows=n,
        flagship_step_ms_median=flagship_timing["step_ms_median"],
        flagship_idle_share=flagship_timing.get("idle_share"), **timing)
    return paths


class _Perturbed:
    """A generator whose batch 0 carries noise on its images (the stream
    phase's control)."""

    def __init__(self, gen, std):
        self.gen, self.std, self.masks = gen, std, gen.masks

    def __len__(self):
        return len(self.gen)

    def on_epoch_end(self):
        self.gen.on_epoch_end()

    def raw_batch(self, i):
        x, y = self.gen.raw_batch(i)
        if i == 0:
            noise = torch.from_numpy(np.random.default_rng(SEED).normal(
                0.0, self.std, tuple(x.shape)).astype(np.float32))
            x = (x.float() + noise).to(x.dtype)
        return x, y


def _params(trainer):
    return [p.detach().clone() for p in trainer.model.parameters()]


def _rel_change_diff(start, a, b):
    """||(a - start) - (b - start)|| / ||b - start|| over all parameters."""
    diff = sum(float((x - y).double().square().sum()) for x, y in zip(a, b))
    change = sum(float((y - s).double().square().sum())
                 for s, y in zip(start, b))
    return (diff / change) ** 0.5


def _streamed_epoch_figures(cfg, gen, echo, cached_ms):
    """One timed and one profiled streamed epoch of ``gen`` at STREAM_ECHO
    ``echo`` (the kernels are warm from the parity runs). Per batch: bytes,
    the copy's ms (events on the copy stream), the producer's ms (host
    clock in its thread), the step's ms per optimizer step (events, the
    wait for its copy included), how long the step waited for its copy,
    the share of each copy that lies inside the union of every step's
    compute interval on the main stream (from the end of its wait for
    its copy to its last launch), and which steps, counted back from the
    copy's own, each copy overlapped (up to PREFETCH_DEPTH steps run in
    flight). The device's idle share is that of the profiled epoch: its
    busy time over its own wall time."""
    loop = StreamedLoop(Trainer(dict(cfg, STREAM_ECHO=echo), device="cuda"),
                        gen)
    loop.timeline = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop.run_train_epoch()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    line = loop.timeline
    loop.timeline = None
    base = line[0]["step_start"]

    def at(event):  # ms since the first step's start, on the device
        return base.elapsed_time(event)

    copies = [(at(r["copy_start"]), at(r["copy_end"])) for r in line]
    steps = [(at(r["step_start"]), at(r["step_end"])) for r in line]
    computes = [(at(r["compute_start"]), at(r["step_end"])) for r in line]

    def overlap(a, b):
        return max(0.0, min(a[1], b[1]) - max(a[0], b[0]))

    # the compute intervals are disjoint (one stream runs them in order)
    inside = [sum(overlap(c, s) for s in computes) / max(c[1] - c[0], 1e-9)
              for c in copies]
    offsets = {}
    for k, c in enumerate(copies):
        for j, s in enumerate(computes):
            if overlap(c, s) > 0:
                offsets[k - j] = offsets.get(k - j, 0) + 1
    by_kernel, profiled_ms = _device_ms_by_kernel(loop.run_train_epoch,
                                                  host=False)
    busy_ms = sum(by_kernel.values())
    pinned = all(b.is_pinned() for b in loop.put_ahead.host_buffers())
    side = loop.put_ahead.stream.cuda_stream != \
        torch.cuda.default_stream().cuda_stream
    check(pinned and side, f"stream: staged host buffers pinned {pinned}, "
          f"copies on a side stream {side}")
    mb = float(np.median([r["bytes"] for r in line])) / 1e6
    copy_ms = float(np.median([c1 - c0 for c0, c1 in copies]))
    return {"echo": echo, "batches": len(line), "epoch_wall_ms": wall_ms,
            "step_ms_median": float(np.median(
                [(s1 - s0) / echo for s0, s1 in steps])),
            "cached_step_ms_median": cached_ms,
            "batch_mb": mb, "copy_ms_median": copy_ms,
            "copy_gb_s": mb / copy_ms,
            "copy_wait_ms_median": float(np.median(
                [max(0.0, c1 - s0) for (_, c1), (s0, _) in
                 zip(copies, steps)])),
            "producer_ms_median": float(np.median(
                [r["producer_ms"] for r in line])),
            "copy_share_inside_steps": inside,
            "copy_overlaps_by_step_offset": {
                str(k): v for k, v in sorted(offsets.items())},
            "device_busy_ms_per_epoch": busy_ms if busy_ms else None,
            "idle_share": 1.0 - busy_ms / profiled_ms if busy_ms else None,
            "profiled_epoch_wall_ms": profiled_ms,
            "figures_s": time.perf_counter() - t0}


def phase_stream(cfg, data_root, work, card):
    """The flagship through cli.train -inmemory false (the streamed loop,
    chained pred_fold), EPOCHS 2: K1 twice for the sample batches, (7 x
    STREAM_ECHO + 2) times an epoch (the streamed eval drops the
    remainder) and once per patient-phase, K2
    once per patient-phase. Then in process, through the in-memory host
    cache with a tiny DEVICE_CACHE_LIMIT_GB: one streamed epoch against one
    device-cached epoch (within STREAM_PARITY_RTOL; a control with batch 0
    perturbed must exceed it); STREAM_ECHO 2 takes two steps per upload
    with differing augmentation draws; the staged host buffers are pinned
    and the copies run on a side stream; figures at STREAM_ECHO 1 and 2,
    for the in-memory and the -inmemory false generator."""
    t0 = time.perf_counter()
    seconds = {}
    scfg = dict(cfg, EPOCHS=2, FOLDS=[0])
    exp, k1, k2, chained, wall_s = _train_cli(
        scfg, data_root, work, "stream", args=["-inmemory", "false"])
    batch = int(cfg["BATCHSIZE"])
    train_steps, full_eval, _ = _cohort_steps(batch)
    test = fold_patients(os.path.join(data_root, "df_kfold.csv"), 0)
    phases = 2 * len(test)
    paths = _cli_launch_checks(
        "stream", k1, k2, chained,
        _sample_launches(scfg) + 2 * (train_steps + full_eval), phases)
    fold = os.path.join(exp, "f0")
    history = _history_rows(fold, 2)
    _check_predictions(fold, test)

    x_tr, y_tr, _, _ = get_trainings_files(
        os.path.join(data_root, "2D"), 0,
        os.path.join(data_root, "df_kfold.csv"))
    pcfg = dict(cfg, SHUFFLE=False, STREAM_DTYPE="bfloat16",
                CACHE_DTYPE="bfloat16", DEVICE_CACHE_LIMIT_GB=1e-6)
    ordered = DataGenerator(x_tr, y_tr, config=pcfg)
    start = _params(Trainer(pcfg, device="cuda"))
    after = {}
    for name, make, data in (
            ("cached", DeviceCachedLoop, ordered),
            ("streamed", StreamedLoop, ordered),
            ("control", StreamedLoop,
             _Perturbed(ordered, STREAM_CONTROL_NOISE))):
        trainer = Trainer(pcfg, device="cuda")
        make(trainer, data).run_train_epoch()
        after[name] = _params(trainer)
    parity = _rel_change_diff(start, after["streamed"], after["cached"])
    control = _rel_change_diff(start, after["control"], after["cached"])
    check(parity <= STREAM_PARITY_RTOL < control,
          f"stream: streamed vs cached {parity}, control {control}, bound "
          f"{STREAM_PARITY_RTOL}")
    seconds["cli_and_parity"] = time.perf_counter() - t0

    draws = []

    def record(draw):
        def wrapped(generator, config, n):
            params = draw(generator, config, n)
            draws.append(params)
            return params
        return wrapped

    echo_loop = StreamedLoop(Trainer(dict(pcfg, STREAM_ECHO=2),
                                     device="cuda"), ordered)
    kernels.gaussian_blur_2d_cuda.launches = 0
    with _patched(device_cache, "draw_params", record):
        echo_loop.run_train_epoch()
    torch.cuda.synchronize()
    echo_k1 = kernels.gaussian_blur_2d_cuda.launches
    same = [all(torch.equal(draws[i][k], draws[i + 1][k]) for k in
                ("rot_k", "shift", "gd_factors"))
            for i in range(0, len(draws), 2)]
    check(echo_k1 == 2 * train_steps and len(draws) == 2 * train_steps
          and echo_loop.trainer.state.step == 2 * train_steps
          and not any(same),
          f"stream: STREAM_ECHO 2 took {echo_loop.trainer.state.step} "
          f"steps, K1 {echo_k1}, {len(draws)} draws, echoes equal {same}")
    seconds["echo"] = time.perf_counter() - t0 - seconds["cli_and_parity"]

    cached_ms = _time_loop(DeviceCachedLoop(Trainer(pcfg, device="cuda"),
                                            ordered))["step_ms_median"]
    disk = DataGenerator(x_tr, y_tr, config=pcfg, in_memory=False)
    figures = {f"{source}-echo{echo}": _streamed_epoch_figures(
        pcfg, data, echo, cached_ms)
        for source, data in (("memory", ordered), ("disk", disk))
        for echo in (1, 2)}
    log("stream", card=card, train_steps=2 * train_steps,
        eval_steps=2 * full_eval, k1_launches=k1, k2_launches=k2,
        train_wall_s=wall_s, pred_fold_wall_s=chained["wall_s"],
        history=history, parity_rel=parity, control_rel=control,
        parity_bound=STREAM_PARITY_RTOL, echo_k1=echo_k1,
        phase_s=dict(seconds, total=time.perf_counter() - t0), **figures)
    return paths


# -- the last slice: more than one process, driven at world size 1 ----------

# distributed: a step through the process group (one rank over NCCL) against
# the plain one-card step from the same weights, rows and draws. Every
# collective at one rank is the identity, so the two differ only where the
# card's kernels are not deterministic; the control (two plain steps) reads
# that spread, and a plain step on other rows must lie far outside each
# bound. The loss is a forward's: rel 1e-5. The gradients the rule read,
# as ||g_a - g_b|| / ||g_b|| over all parameters: 1e-3 (cuDNN's
# weight-gradient reductions reorder). Adam's first step moves each weight
# by about the learning rate whatever its gradient's size, so a gradient
# that lies within that noise of 0 can flip its weight's step: the share of
# weights whose value differs after the step is held to 1e-4, and
# max |delta param| is reported (such a flip moves a weight by 2 x lr).
DIST_LOSS_RTOL = 1e-5
DIST_GRAD_RTOL = 1e-3
DIST_MOVED_SHARE = 1e-4
# a step on other rows must lie this many times beyond each bound
DIST_CONTROL_FACTOR = 10
TORCHRUN_TIMEOUT_S = 300


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _step_collectives(model, manual, dtype="bfloat16"):
    """The collectives one step runs, as tests/test_torch_multiprocess.py
    lists them: the global view's BatchNorm sums and gathers and its one
    float32 gradient mean, or the explicit-collectives step's three
    means."""
    k = sum(isinstance(m, BatchNorm) for m in model.modules())
    if manual:
        return [f"grad_mean:{dtype}"] + ["batch_stats_mean:float32"] * \
            (k > 0) + ["logs_mean:float32"]
    return (["all_reduce_sum:float32"] * k + ["all_gather:float32"] * 2
            + ["all_gather.backward:float32"]
            + ["all_reduce_sum.backward:float32"] * k
            + ["grad_mean:float32"])


def _one_step(cfg, gen, mesh, rows):
    """One cached-loop step from the seeded init on ``rows``: the loss,
    the parameters after it, the gradients the rule read, the collectives
    it ran and the loop."""
    loop = DeviceCachedLoop(Trainer(cfg, device="cuda", mesh=mesh), gen)
    with dist_mesh.record_collectives() as calls:
        loss = float(loop.train_step(rows)["loss"])
    model = loop.trainer.model
    return (loss, _params(loop.trainer),
            [p.grad.detach().double() for p in model.parameters()], calls,
            loop)


def _step_diffs(a, b):
    """|delta loss|, the gradients' relative L2 difference, the share of
    weights that differ and max |delta param| of two ``_one_step``s."""
    grad_diff = sum(float((x - y).square().sum()) for x, y in zip(a[2], b[2]))
    grad_norm = sum(float(y.square().sum()) for y in b[2])
    moved = sum(int((x != y).sum()) for x, y in zip(a[1], b[1]))
    return {"loss_abs_diff": abs(a[0] - b[0]),
            "grad_rel_diff": (grad_diff / grad_norm) ** 0.5,
            "params_differing_share": moved / sum(p.numel() for p in b[1]),
            "param_max_abs_diff": max(float((x - y).abs().max())
                                      for x, y in zip(a[1], b[1]))}


def _step_against_plain(name, cfg, gen, mesh):
    """The distributed step against the plain one, with the controls, and
    their warm step ms in interleaved rounds."""
    plain_mesh = dist_mesh.Mesh()
    probe = DeviceCachedLoop(Trainer(cfg, device="cuda", mesh=plain_mesh),
                             gen)
    idx = torch.from_numpy(probe._epoch_indices(probe.n_train, False)).cuda()
    del probe
    dist_step = _one_step(cfg, gen, mesh, idx[0])
    plain = _one_step(cfg, gen, plain_mesh, idx[0])
    control = _step_diffs(_one_step(cfg, gen, plain_mesh, idx[0]), plain)
    other = _step_diffs(_one_step(cfg, gen, plain_mesh, idx[1]), plain)
    figures = {"distributed": _step_diffs(dist_step, plain),
               "control": control, "other_rows": other,
               "collectives": dist_step[3]}
    manual = bool(cfg.get("GRAD_ALLREDUCE_DTYPE"))
    want = _step_collectives(dist_step[4].trainer.model, manual)
    check(dist_step[3] == want and plain[3] == [],
          f"distributed {name}: collectives {dist_step[3]}, want {want} "
          f"(plain {plain[3]})")
    bounds = {"loss_abs_diff": DIST_LOSS_RTOL * abs(plain[0]),
              "grad_rel_diff": DIST_GRAD_RTOL,
              "params_differing_share": DIST_MOVED_SHARE}
    within = all(figures[arm][k] <= bound for arm in ("distributed",
                                                      "control")
                 for k, bound in bounds.items())
    outside = all(other[k] > DIST_CONTROL_FACTOR * bound
                  for k, bound in bounds.items())
    check(within and outside, f"distributed {name}: {figures}, bounds "
          f"{bounds}, other rows beyond {DIST_CONTROL_FACTOR} x")
    rows = iter(range(10 ** 6))
    dloop, ploop = dist_step[4], plain[4]
    figures["bounds"] = bounds
    figures["step_ms_paired"] = _paired_step_ms(
        "distributed", lambda: dloop.train_step(idx[next(rows) % len(idx)]),
        "plain", lambda: ploop.train_step(idx[next(rows) % len(idx)]))
    window = 4
    for arm, loop in (("distributed", dloop), ("plain", ploop)):
        by_kernel, wall_ms = _device_ms_by_kernel(lambda: [
            loop.train_step(idx[next(rows) % len(idx)])
            for _ in range(window)])
        busy = sum(by_kernel.values())
        figures[f"{arm}_profile"] = {
            "wall_ms_per_step": wall_ms / window,
            "device_busy_ms_per_step": busy / window if busy else None,
            "nccl_ms_per_step": sum(v for k, v in by_kernel.items()
                                    if "nccl" in k.lower()) / window}
    return figures


def _torchrun(cfg, data_root, work, ranks=1):
    """``python -m torch.distributed.run --standalone --nproc_per_node
    <ranks> -m cmrtpu_torch.cli.train`` on the cohort: its exit code, wall
    seconds, the fold and the end of its output."""
    cfg_path = os.path.join(work, f"{cfg['EXPERIMENT']}.json")
    with open(cfg_path, "w") as fh:
        json.dump(cfg, fh)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(ranks), "-m", "cmrtpu_torch.cli.train",
         "-cfg", cfg_path, "-data", data_root], cwd=work, env=env,
        capture_output=True, text=True, timeout=TORCHRUN_TIMEOUT_S)
    runs = glob.glob(os.path.join(work, cfg["EXPERIMENTS_ROOT"],
                                  cfg["EXPERIMENT"], "*", "f0"))
    return (proc.returncode, time.perf_counter() - t0, runs,
            (proc.stdout + proc.stderr)[-3000:])


# --cards N: the flagship with dropout 0 over N cards against one card. The
# augmentation draws are the global batch's on every rank, so both take the
# same steps up to the cards' kernels (bf16 convolutions at batch 16 / N
# pick other algorithms than at 16): each epoch's loss and val_loss within
# this relative bound
CARDS_HISTORY_RTOL = 1e-2


def _history_with_time(fold):
    with open(os.path.join(fold, "history.csv")) as fh:
        return [{k: float(r[k]) for k in ("loss", "val_loss", "epoch_time")}
                for r in csv.DictReader(fh)]


def cards_main(n):
    """``python3 chip_smoke.py --cards N``: the multi-process layer over N
    cards of one host (NCCL, one rank a card), each run a torchrun of
    cli.train on the phantom cohort (EPOCHS 2, chained pred_fold): the
    flagship with dropout 0 at one rank and at N, whose histories must
    agree within CARDS_HISTORY_RTOL, and sharded_cache_config.json at N
    (each rank loads and holds one block of the cache). Each run must exit
    0 and leave one model.npz and the test patients' predictions."""
    check(not _loaded_foreign(), f"importing the port loaded "
          f"{_loaded_foreign()}")
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        print(f"chip_smoke --cards {n}: needs {n} CUDA cards",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    phase_build()
    with open(FLAGSHIP, encoding="utf-8") as fh:
        flagship = dict(json.load(fh), EPOCHS=2, FOLDS=[0], DROPOUT_MIN=0.0,
                        DROPOUT_MAX=0.0)
    with open(SHARDED_TEMPLATE, encoding="utf-8") as fh:
        sharded = dict(json.load(fh), EPOCHS=2, FOLDS=[0])
    runs = {"flagship_w1": (flagship, 1), f"flagship_w{n}": (flagship, n),
            f"sharded_w{n}": (sharded, n)}
    figures = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cards_") as work:
        data_root = os.path.join(work, "data")
        _make_dataset(data_root)
        test = fold_patients(os.path.join(data_root, "df_kfold.csv"), 0)
        for name, (cfg, ranks) in runs.items():
            cfg = dict(cfg, EXPERIMENT=f"cards_{name}")
            rc, wall_s, folds, tail = _torchrun(cfg, data_root, work, ranks)
            check(rc == 0 and len(folds) == 1,
                  f"cards {name}: exit {rc}, folds {folds}:\n{tail}")
            models = [f for f in _files(folds[0]) if f.endswith("model.npz")]
            check(len(models) == 1, f"cards {name}: model files {models}")
            _check_predictions(folds[0], test)
            figures[name] = {"ranks": ranks, "wall_s": wall_s,
                             "history": _history_with_time(folds[0])}
    one, many = (figures[f"flagship_w{w}"]["history"] for w in (1, n))
    rel = {k: max(abs(a[k] - b[k]) / abs(a[k]) for a, b in zip(one, many))
           for k in ("loss", "val_loss")}
    check(len(one) == len(many) == 2
          and all(v <= CARDS_HISTORY_RTOL for v in rel.values()),
          f"cards: flagship at {n} ranks against 1: {rel}, bound "
          f"{CARDS_HISTORY_RTOL}")
    print(json.dumps({"cards": figures, "flagship_rel_diff": rel,
                      "bound": CARDS_HISTORY_RTOL}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def phase_distributed(cfg, data_root, work, gen, card):
    """The multi-process layer over NCCL at world size 1, in this process:
    sharded_cache_config.json at its widths, EPOCHS 2, through cli.train
    (chained pred_fold): K1 and K2 as phase sharded-cache counts them for
    the same fold, one model.npz; then one global-view step (flagship) and
    one explicit-collectives step (sharded template) against the plain
    step, their collectives as the CPU test lists them, and their warm
    step ms against the plain step's in interleaved rounds. The process
    group is left at the end. Last, one torchrun launch of cli.train at
    EPOCHS 1 must exit 0 and leave the fold's files."""
    t0 = time.perf_counter()
    check(dist_mesh.initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                                           device="cuda", timeout_s=300),
          "distributed: no process group")
    try:
        mesh = dist_mesh.create_mesh(cfg)
        check(mesh.distributed and mesh.world == 1
              and torch.distributed.get_backend() == "nccl",
              f"distributed: mesh {mesh}, backend "
              f"{torch.distributed.get_backend()}")
        with open(SHARDED_TEMPLATE, encoding="utf-8") as fh:
            scfg = dict(json.load(fh), EPOCHS=2, FOLDS=[0],
                        EXPERIMENT="rvip_sharded_cache_distributed")
        exp, k1, k2, chained, wall_s = _train_cli(scfg, data_root, work,
                                                  "distributed")
        train_steps, _, eval_steps = _cohort_steps(int(scfg["BATCHSIZE"]))
        test = fold_patients(os.path.join(data_root, "df_kfold.csv"), 0)
        phases = 2 * len(test)
        paths = _cli_launch_checks(
            "distributed", k1, k2, chained,
            _sample_launches(scfg) + 2 * (train_steps + eval_steps), phases)
        fold = os.path.join(exp, "f0")
        history = _history_rows(fold, 2)
        _check_predictions(fold, test)
        models = [f for f in _files(exp) if f.endswith("model.npz")]
        check(len(models) == 1, f"distributed: model files {models}")
        steps = {name: _step_against_plain(name, step_cfg, gen, mesh)
                 for name, step_cfg in (("global_view", cfg),
                                        ("explicit", scfg))}
    finally:
        dist_mesh.shutdown_distributed()
    check(not torch.distributed.is_initialized(),
          "distributed: the process group outlived the phase")
    rcfg = dict(cfg, EPOCHS=1, FOLDS=[0], EXPERIMENT="torchrun")
    rc, torchrun_s, runs, tail = _torchrun(rcfg, data_root, work)
    check(rc == 0 and len(runs) == 1, f"distributed: torchrun exit {rc}, "
          f"folds {runs}:\n{tail}")
    run_files = _files(runs[0])
    check(any(f.endswith("model.npz") for f in run_files)
          and any(f.endswith("fold_complete.json") for f in run_files)
          and len(_history_rows(runs[0], 1)) == 1
          and os.listdir(os.path.join(runs[0], "pred")),
          f"distributed: torchrun's fold holds {sorted(run_files)}")
    log("distributed", card=card, world_size=1, backend="nccl",
        train_steps=2 * train_steps, eval_steps=2 * eval_steps,
        k1_launches=k1, k2_launches=k2, train_wall_s=wall_s,
        pred_fold_wall_s=chained["wall_s"], history=history, **steps,
        torchrun_exit=rc, torchrun_wall_s=torchrun_s,
        phase_s=time.perf_counter() - t0)
    return paths


# -- slice 4: the 3D cine U-Net and CC_FILTER '3d' --------------------------

CINE = os.path.join(TEMPLATES, "cine_3d_config.json")
# train-3d: the ported cine demo's cohort at the template's 8 frames, 224^2
# at 1.4 mm (RESAMPLE to the template's 1.2 mm, then cropped to DIM)
CINE_T, CINE_HW, CINE_TRAIN, CINE_VAL = 8, 224, 24, 8
# forward-3d: the template's U-Net at its widths, card bf16 and card f32
# (TF32 off) against float64 on the card, at this batch. Measured on an H100
# (700 W), bf16 against float64: upsample decoder max 0.0668, mean 0.00723;
# transpose-conv decoder max 0.0172, mean 0.00186 (PERF.md). Each bound
# keeps ~2x over its decoder's error; the controls (a constant 0.5, and the
# net with one norm skipped) lay at max 0.29-0.81 / mean 0.028-0.22, except
# the transpose net without its bottleneck norm: max 0.0226, mean 0.00231,
# within 1.3x of bf16 rounding, since every later norm re-normalises what
# the bottleneck's skipped scale changes. That control is logged but not
# held to the bounds
FWD3D_BATCH = 2
BF16_3D_MAX_ATOL, BF16_3D_MEAN_ATOL = 0.15, 0.015
BF16_3D_T_MAX_ATOL, BF16_3D_T_MEAN_ATOL = 0.04, 0.004
F32_3D_ATOL = 1e-3
# the 3D CC kernel's three passes, as the profiler names them
CC3D_KERNELS = ("cc3d_local_kernel", "cc3d_face_kernel",
                "cc3d_flatten_kernel")
CUBE = np.ones((3, 3, 3), bool)


def k1_3d_cases():
    """K1 on the 3D path: one train step's [B * C * T, H, W] = [8 * 2 * 8,
    224, 224] binary landmark planes, sigma 2 (radius 8)."""
    planes = _discs(np.random.default_rng(SEED), 8 * CINE_T, H, W, (1, 2))
    return [("cine-s2", np.concatenate([planes == 1, planes == 2])
             .astype(np.float32), 2.0)]


def _calibrate_bn(model, x):
    """Running averages from one train-mode pass with momentum 0, so an
    eval-mode BatchNorm normalises as a trained net's does (a fresh net's
    zero mean and unit variance leave its activations unscaled)."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.momentum = 0.0
    with torch.no_grad():
        model.train()(x, generator=torch.Generator(x.device).manual_seed(
            SEED))
    for m in norms:
        m.momentum = 0.99
    return model.eval()


def phase_forward_3d(cfg, phase, bf16_max, bf16_mean, unheld=()):
    """The 3D template's U-Net at its published widths on the card in bf16
    and in f32 (TF32 off) against a float64 run of the same weights on the
    card; controls that skip a norm must fall outside the bf16 bounds, but
    those named in ``unheld``, which are only logged."""
    with _tf32_off():
        f32_cfg = dict(cfg, MIXED_PRECISION=False)
        x = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
            (FWD3D_BATCH, *cfg["DIM"], 1)).astype(np.float32)).cuda()
        card_f32 = _calibrate_bn(build_model(f32_cfg).reset_parameters(
            torch.Generator().manual_seed(SEED)).cuda(), x)
        model = build_model(cfg).cuda().eval()
        model.load_state_dict(card_f32.state_dict())
        ref = build_model(f32_cfg).cuda().eval()
        ref.load_state_dict(card_f32.state_dict())
        _as_float64(ref)
        with torch.inference_mode():
            want = ref(x.double()).float().cpu().numpy()
            bf16 = model(x).cpu().numpy()
            f32 = card_f32(x).cpu().numpy()
            ms = cuda_ms(lambda: model(x), 5)
            ms_f32 = cuda_ms(lambda: card_f32(x), 5)
            ms_f64 = cuda_ms(lambda: ref(x.double()), 1)
            controls = {"constant_0.5": _errors(np.full_like(want, 0.5),
                                                want)}
            for block in ("DownBlock_0.ConvBlock_0", "ConvBlock_1",
                          f"UpBlock_{model.depth - 1}.ConvBlock_1"):
                out = _without_norm(model, block)(x).cpu().numpy()
                controls[f"no_norm_{block}"] = _errors(out, want)
    shape = (FWD3D_BATCH, *cfg["DIM"], 2)
    check(bf16.shape == shape and np.isfinite(bf16).all(),
          f"{phase}: bad output {bf16.shape}")
    f32_err, bf16_err = _errors(f32, want), _errors(bf16, want)
    bounds = {"f32_max": F32_3D_ATOL, "bf16_max": bf16_max,
              "bf16_mean": bf16_mean}
    log(phase, batch=FWD3D_BATCH, dim=cfg["DIM"],
        use_upsample=bool(cfg.get("USE_UPSAMPLE", True)), ms=ms,
        f32_ms=ms_f32, f64_ms=ms_f64, f32_vs_f64=f32_err,
        bf16_vs_f64=bf16_err, controls_vs_f64=controls, bounds=bounds,
        controls_not_held=list(unheld))
    check(f32_err["max"] <= F32_3D_ATOL,
          f"{phase}: card f32 max {f32_err['max']} > {F32_3D_ATOL}")
    check(bf16_err["max"] <= bf16_max and bf16_err["mean"] <= bf16_mean,
          f"{phase}: card bf16 {bf16_err} outside the bounds {bounds}")
    for name, err in controls.items():
        check(name in unheld or err["max"] > bf16_max
              or err["mean"] > bf16_mean,
              f"{phase}: control {name} {err} passes the bf16 bounds, which "
              "therefore cannot tell a wrong forward from bf16 rounding")


def _cine_cohort(work):
    """The ported cine demo's cohort for train-3d and train-hybrid: 24
    train and 8 validation volumes through DataGenerator (the template's
    RESAMPLE to 1.2 mm, cropped to DIM). Returns the generators and the
    seconds of the cohort's writing and of the host stage."""
    with open(CINE, encoding="utf-8") as fh:
        cfg = json.load(fh)
    t0 = time.perf_counter()
    xs, ys, _ = generate_cine_cohort(work, CINE_TRAIN + CINE_VAL, CINE_T,
                                     CINE_HW)
    cohort_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    train = DataGenerator(xs[:CINE_TRAIN], ys[:CINE_TRAIN], config=cfg)
    val = DataGenerator(xs[CINE_TRAIN:], ys[CINE_TRAIN:], config=cfg)
    host_s = time.perf_counter() - t0
    check(train._cache_x.shape == (CINE_TRAIN, *cfg["DIM"])
          and val._cache_y.shape == (CINE_VAL, *cfg["DIM"]),
          f"cine cohort: caches {train._cache_x.shape}, "
          f"{val._cache_y.shape}")
    return train, val, {"cohort_s": cohort_s, "host_stage_s": host_s}


def _reset_counts():
    """K1's and K2's counts to 0. The 3D CC kernel's is left as it is:
    main sets it to 0 once the CC_FILTER '3d' paths have run and checks at
    the end that no later path launched it."""
    kernels.gaussian_blur_2d_cuda.launches = 0
    kernels.converge_labels_cuda.launches = 0


def _reset_all():
    """All three kernels' counts to 0."""
    for k in (kernels.gaussian_blur_2d_cuda, kernels.converge_labels_cuda,
              kernels.converge_labels_3d_cuda):
        k.launches = 0


def _counts():
    return {"k1": kernels.gaussian_blur_2d_cuda.launches,
            "k2": kernels.converge_labels_cuda.launches,
            "cc3d": kernels.converge_labels_3d_cuda.launches}


def _fit_cine(cfg, train, val, phase, work):
    """``cfg`` (the 3D template with its MODEL_VARIANT), EPOCHS 2, through
    Trainer.fit_cached on the cine cohort: K1 exactly once per train and
    eval step; Trainer.predict on the validation volumes equal to the
    model.npz it saves restored through Predictor; then warm steps timed
    and profiled, with the peak memory. Returns the launches and the
    line's fields."""
    batch = int(cfg["BATCHSIZE"])
    steps, eval_steps = CINE_TRAIN // batch, -(-CINE_VAL // batch)
    trainer = Trainer(cfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    hist = trainer.fit_cached(train, val)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _counts()
    fit_peak = torch.cuda.max_memory_allocated()
    want = 2 * (steps + eval_steps)
    check(launches == {"k1": want, "k2": 0, "cc3d": 0},
          f"{phase}: launches {launches} for 2 x ({steps} train + "
          f"{eval_steps} eval) steps, want K1 {want} and no CC")
    keys = ("loss", "val_loss", "dice_coef_labels", "val_dice_coef_labels")
    check(len(hist) == 2 and all(np.isfinite(h[k]) for h in hist
                                 for k in keys),
          f"{phase}: history {hist}")

    x = normalise_batch(torch.from_numpy(val._cache_x),
                        str(cfg.get("SCALER", "MinMax")))[..., None].numpy()
    probs = trainer.predict(x)
    check(probs.shape == (CINE_VAL, *cfg["DIM"], 2)
          and np.isfinite(probs).all(),
          f"{phase}: Trainer.predict gave {probs.shape}")
    model_dir = os.path.join(work, phase, "model")
    save_weights(model_dir, trainer.serving_params)
    served = Predictor(cfg, model_dir, device="cuda").predict(x)
    check(np.array_equal(served, probs),
          f"{phase}: the restored Predictor differs from Trainer.predict "
          f"by {float(np.abs(served - probs).max())}")

    loop = DeviceCachedLoop(trainer, train)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timing = _time_loop(loop)
    step_peak = torch.cuda.max_memory_allocated()
    del loop, trainer
    torch.cuda.empty_cache()
    fields = dict(
        variant=cfg.get("MODEL_VARIANT", "unet"), dim=cfg["DIM"],
        batch=batch, cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        train_steps=2 * steps, eval_steps=2 * eval_steps, launches=launches,
        fit_s=fit_s, peak_memory_bytes_fit=fit_peak,
        peak_memory_bytes_steps=step_peak,
        frames_per_s=batch * CINE_T / (timing["step_ms_median"] / 1e3),
        history=[{k: h[k] for k in keys + ("epoch_time",)} for h in hist],
        predict_equal_restored=True, **timing)
    return launches, fields


def phase_train_3d(train, val, cohort, work):
    """The 3D template at its published widths (REMAT true, as shipped),
    EPOCHS 2, through DataGenerator + Trainer.fit_cached on the cine
    cohort (``_fit_cine``); then the same loop's warm step at REMAT 0, so
    that the cost of remat stands beside it. Returns the launches by
    path."""
    with open(CINE, encoding="utf-8") as fh:
        cfg = dict(json.load(fh), EPOCHS=2)
    check(cfg["REMAT"] is True, f"train-3d: the template's REMAT "
          f"{cfg['REMAT']}")
    launches, fields = _fit_cine(cfg, train, val, "train-3d", work)
    loop = DeviceCachedLoop(Trainer(dict(cfg, REMAT=0), device="cuda"),
                            train)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    remat0 = _time_loop(loop)
    remat0 = {"step_ms_median": remat0["step_ms_median"],
              "peak_memory_bytes_steps": torch.cuda.max_memory_allocated()}
    del loop
    torch.cuda.empty_cache()
    log("train-3d", **cohort, **fields, remat=cfg["REMAT"],
        remat0=remat0)
    return {"train_3d": launches}


# -- the skip list: REMAT, BN_BF16, WS and its int8 twins, the probes -------

REMATS = (0, 1, 2, True)
# remat: one step of the cine template at REMAT 0, 1, 2 and true from the
# same weights, batch and dropout generator state, cuDNN deterministic. The
# recompute runs the same kernels on the same inputs, so the loss and the
# running averages are equal bit for bit; the gradients are held within
# REMAT_GRAD_BOUND x max |g| of REMAT 0's (what is left is the order of
# the backward's atomics), a bound that REMAT 0 against itself meets and
# the naive wrap (dropout redrawn in the recompute) must break
REMAT_GRAD_BOUND = 1e-3
# bn-bf16: example_config's widths at batch 16: the BN_BF16 net's eval
# forward and one step's gradients and running averages against float64,
# each within BN_BF16_FACTOR x the distance of the float32-BatchNorm net
# (bf16 convs) from float64, plus BN_BF16_SLACK; its loss within
# BN_BF16_LOSS_RTOL of float64's (a relative difference of two losses
# cancels too much to compare as a ratio)
BN_BF16_BATCH = 16
BN_BF16_FACTOR = 2.0
BN_BF16_SLACK = 1e-3
BN_BF16_LOSS_RTOL = 1e-2
PROBE3D_ROWS = ("base", "remat1", "remat_full", "bn_bf16")


def _grad_gap(a, b):
    """max |a - b| over every gradient, over the largest |b|."""
    return max(float((a[k] - b[k]).abs().max()) for k in b) / max(
        float(v.abs().max()) for v in b.values())


@contextlib.contextmanager
def _cudnn_deterministic():
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def _remat_step(cfg, state, x, y, remat):
    """One forward and backward of ``cfg`` at ``remat`` from ``state``:
    (loss, gradients, buffers after it, peak bytes, the model)."""
    model = build_model(dict(cfg, REMAT=remat)).cuda()
    model.load_state_dict(state)
    model.train()
    loss_fn = get_loss(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = model(x, generator=torch.Generator("cuda").manual_seed(SEED))
    loss = loss_fn(y, out)
    loss.backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    grads = {n: p.grad.detach().float() for n, p in model.named_parameters()}
    stats = {n: b.detach().clone() for n, b in model.named_buffers()}
    return float(loss.detach()), grads, stats, peak, model


def phase_remat(cine, train):
    """remat: the cine template as shipped (REMAT true, BatchNorm, bf16,
    batch 8 of [8, 224, 224]) one step at REMAT 0, 1, 2 and true from one
    set of weights, one augmented batch (its draws injected once) and one
    dropout generator state: equal losses and running averages, gradients
    within REMAT_GRAD_BOUND of REMAT 0's; a wrap without the generator
    replay must break the bound, one that moves the running averages in
    the recompute their equality. Peak memory and step ms per value.
    Returns the launches (K1 once, for the batch)."""
    cfg = dict(cine)
    batch = int(cfg["BATCHSIZE"])
    _reset_counts()
    imgs = torch.from_numpy(train._cache_x[:batch]).cuda().float()
    msks = torch.from_numpy(train._cache_y[:batch]).cuda().float()
    params = draw_params(torch.Generator("cuda").manual_seed(SEED), cfg,
                         batch)
    imgs, msks = apply_params(params, imgs, msks)
    x, y = finalize_batch(imgs, msks, cfg, masks=True)
    launches = _counts()
    check(launches == {"k1": 1, "k2": 0, "cc3d": 0},
          f"remat: launches {launches} for one batch")
    state = build_model(cfg).reset_parameters(
        torch.Generator().manual_seed(SEED)).state_dict()
    rows = {}
    with _cudnn_deterministic():
        loss0, grads0, stats0, _, _ = _remat_step(cfg, state, x, y, 0)
        _, again, _, _, _ = _remat_step(cfg, state, x, y, 0)
        rerun_gap = _grad_gap(again, grads0)
        for remat in REMATS:
            loss, grads, stats, peak, model = _remat_step(cfg, state, x, y,
                                                          remat)
            trainer = Trainer(dict(cfg, REMAT=remat), model=model,
                              device="cuda")
            torch.cuda.reset_peak_memory_stats()
            step_ms = _warm_step_ms(lambda: trainer.state.train_step(x, y),
                                    reps=5, warm=2)
            rows[str(remat)] = {
                "loss": loss, "grad_gap": _grad_gap(grads, grads0),
                "stats_equal": all(torch.equal(stats[k], stats0[k])
                                   for k in stats0),
                "peak_memory_bytes_fwd_bwd": peak,
                "peak_memory_bytes_steps": torch.cuda.max_memory_allocated(),
                "step_ms_median": step_ms,
                "frames_per_s": batch * CINE_T / (step_ms / 1e3)}
            del trainer, model, grads, stats
            torch.cuda.empty_cache()
        with _patched(unet_module, "_replayed",
                      lambda orig: lambda gen, st: contextlib.nullcontext()):
            _, naive, _, _, _ = _remat_step(cfg, state, x, y, True)
        with _patched(unet_module, "_frozen_stats",
                      lambda orig: lambda block: contextlib.nullcontext()):
            _, _, twice, _, _ = _remat_step(cfg, state, x, y, True)
    controls = {"naive_wrap_grad_gap": _grad_gap(naive, grads0),
                "double_bn_update_stats_equal": all(
                    torch.equal(twice[k], stats0[k]) for k in stats0)}
    log("skip-list/remat", batch=batch, dim=cfg["DIM"], rows=rows,
        rerun_grad_gap=rerun_gap, grad_bound=REMAT_GRAD_BOUND,
        controls=controls, launches=launches)
    check(rerun_gap <= REMAT_GRAD_BOUND,
          f"remat: REMAT 0 against itself {rerun_gap} > {REMAT_GRAD_BOUND}")
    for remat, row in rows.items():
        check(row["loss"] == loss0 and row["stats_equal"]
              and row["grad_gap"] <= REMAT_GRAD_BOUND,
              f"remat {remat}: {row} against REMAT 0's loss {loss0}")
    check(controls["naive_wrap_grad_gap"] > REMAT_GRAD_BOUND
          and not controls["double_bn_update_stats_equal"],
          f"remat: the controls {controls} pass the checks")
    return launches


def _bn_bf16_models(cfg, x):
    """The BN_BF16 net, the float32-BatchNorm net (bf16 convs) and their
    float64 evaluation on one set of weights, running averages from one
    train-mode pass of the float32 net."""
    f32_cfg = dict(cfg, BN_BF16=False, MIXED_PRECISION=False)
    ref = _calibrate_bn(build_model(f32_cfg).reset_parameters(
        torch.Generator().manual_seed(SEED)).cuda(), x)
    state = ref.state_dict()
    models = {}
    for name, c in (("bn_bf16", dict(cfg, BN_BF16=True)),
                    ("f32_bn", dict(cfg, BN_BF16=False)),
                    ("f64", f32_cfg)):
        models[name] = build_model(c).cuda()
        models[name].load_state_dict(state)
    _as_float64(models["f64"])
    check(isinstance(models["bn_bf16"].DownBlock_0.ConvBlock_0.BatchNorm_0,
                     unet_module.BF16BatchNorm), "bn-bf16: no BF16BatchNorm")
    return models


def phase_bn_bf16():
    """bn-bf16: example_config's widths (BatchNorm, bf16, 224^2) at batch
    16 with BN_BF16: the eval forward and one train step's loss, gradients
    and running averages against float64, each within BN_BF16_FACTOR x
    the float32-BatchNorm net's distance (+ BN_BF16_SLACK); peak memory of
    a forward and backward beside the float32-BatchNorm net's."""
    with open(os.path.join(TEMPLATES, "example_config.json"),
              encoding="utf-8") as fh:
        cfg = dict(json.load(fh), BN_BF16=True)
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.standard_normal(
        (BN_BF16_BATCH, *cfg["DIM"], 1)).astype(np.float32)).cuda()
    y = torch.from_numpy((rng.random((BN_BF16_BATCH, *cfg["DIM"], 2))
                          > 0.995).astype(np.float32)).cuda()
    with _tf32_off():
        models = _bn_bf16_models(cfg, x)
        with torch.inference_mode():
            outs = {n: m.eval()(x.double() if n == "f64" else x).float()
                    for n, m in models.items()}
        fwd = {n: _errors(outs[n].cpu().numpy(), outs["f64"].cpu().numpy())
               for n in ("bn_bf16", "f32_bn")}
        loss_fn = get_loss(cfg)
        steps, peaks = {}, {}
        for name, model in models.items():
            model.train()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = model(x.double() if name == "f64" else x,
                        generator=torch.Generator("cuda").manual_seed(SEED))
            loss = loss_fn(y.double() if name == "f64" else y, out)
            loss.backward()
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated()
            steps[name] = {
                "loss": float(loss.detach()),
                "grads": {n: p.grad.detach().double() for n, p in
                          model.named_parameters()},
                "averages": {n: b.detach().double() for n, b in
                             model.named_buffers() if "running" in n}}
    ref = steps["f64"]
    step_err = {}
    for name in ("bn_bf16", "f32_bn"):
        s = steps[name]
        step_err[name] = {
            "loss_rel": abs(s["loss"] - ref["loss"]) / abs(ref["loss"]),
            "grad_gap": _grad_gap(s["grads"], ref["grads"]),
            "averages_gap": _grad_gap(s["averages"], ref["averages"])}
    log("skip-list/bn-bf16", batch=BN_BF16_BATCH, dim=cfg["DIM"],
        forward_vs_f64=fwd, step_vs_f64=step_err,
        peak_memory_bytes_fwd_bwd={k: peaks[k] for k in ("bn_bf16",
                                                         "f32_bn")},
        factor=BN_BF16_FACTOR, slack=BN_BF16_SLACK,
        loss_rtol=BN_BF16_LOSS_RTOL)
    held = {f"forward {k}": (fwd["bn_bf16"][k], fwd["f32_bn"][k])
            for k in ("max", "mean")}
    held.update({k: (step_err["bn_bf16"][k], step_err["f32_bn"][k])
                 for k in ("grad_gap", "averages_gap")})
    for name, (got, base) in held.items():
        check(got <= BN_BF16_FACTOR * base + BN_BF16_SLACK,
              f"bn-bf16: {name} {got} against float32 BatchNorm's {base}")
    check(step_err["bn_bf16"]["loss_rel"] <= BN_BF16_LOSS_RTOL,
          f"bn-bf16: loss {step_err['bn_bf16']} against float64's")


def _write_twin(qcfg, qvars, dst):
    """A fold directory for the int8 twin (config, model.npz)."""
    qcfg = dict(qcfg, EXP_PATH=dst, MODEL_PATH=os.path.join(dst, "model"))
    os.makedirs(os.path.join(dst, "config"), exist_ok=True)
    with open(os.path.join(dst, "config", "config.json"), "w") as fh:
        json.dump(qcfg, fh, indent=2, default=str)
    save_weights(qcfg["MODEL_PATH"], flax_to_state_dict(
        qvars["params"], qvars["batch_stats"]))
    return dst


def phase_ws(cfg, data_root, test, work):
    """ws: the flagship with WEIGHT_STANDARDISATION and WS_I_UNDERSTAND
    through cli.train (EPOCHS 2, chained pred_fold) on the train phase's
    cohort: K1 once per sample batch, step and patient-phase, K2 once per
    patient-phase, the fold's weights WSConv_0 with no norm; then its int8
    twins without and with bias correction, each served through cli.serve
    (K2 once per study and the warm-up), and their |delta prob| against
    the float fold at batch 16. Returns the launches by path."""
    wcfg = dict(cfg, WEIGHT_STANDARDISATION=True, WS_I_UNDERSTAND=True,
                EPOCHS=2, FOLDS=[0])
    exp, k1, k2, chained, wall_s = _train_cli(wcfg, data_root, work, "ws")
    batch = int(wcfg["BATCHSIZE"])
    steps = 2 * (6 * 2 * Z // batch) + 2 * -(-(2 * 2 * Z) // batch) \
        + _sample_launches(wcfg)
    phases = 2 * len(test)
    by_path = _cli_launch_checks("ws", k1, k2, chained, steps, phases)
    fold = os.path.join(exp, "f0")
    _check_predictions(fold, test)
    history = _history_rows(fold, 2)
    params, stats = load_weights(os.path.join(fold, "model"))
    keys = set(_flatten(params))
    check(("DownBlock_0", "ConvBlock_0", "WSConv_0", "gain") in keys
          and not any("Norm" in "/".join(k) for k in keys)
          and not _flatten(stats), "ws: the fold's weights are not WS")
    fcfg = normalise_config(_fold_config(fold))
    x = _extra_batch(data_root, test, fcfg)
    live = Predictor(fcfg, os.path.join(fold, "model"), device=DEV).predict(x)
    x_train, _, _, _ = get_trainings_files(
        os.path.join(data_root, "2D"), 0,
        os.path.join(data_root, "df_kfold.csv"))
    calib = list(calibration_batches_from_studies(x_train, fcfg,
                                                  batch=EXTRA_BATCH))
    twins = {}
    for corrected in (False, True):
        tag = "ws_int8_bias_corrected" if corrected else "ws_int8"
        t0 = time.perf_counter()
        qcfg, qvars = quantize_model(fcfg, {"params": params,
                                            "batch_stats": stats}, calib,
                                     bias_correction=corrected, device=DEV)
        quantize_s = time.perf_counter() - t0
        twin = _write_twin(qcfg, qvars, os.path.join(work, tag, "f0"))
        by_path[f"serve_{tag}"] = _serve_fold(
            twin, os.path.join(work, f"serve_{tag}"), f"serve-{tag}",
            {"msk": {0, 1, 2}})
        served = Predictor(qcfg, os.path.join(twin, "model"),
                           device=DEV).predict(x)
        delta = np.abs(served - live)
        check(np.isfinite(delta).all(), f"ws: {tag} outputs not finite")
        twins[tag] = {"quantize_s": quantize_s,
                      "max_abs_dprob": float(delta.max()),
                      "mean_abs_dprob": float(delta.mean())}
    log("skip-list/ws", train_wall_s=wall_s, k1_launches=k1,
        k2_launches=k2, history=history, calib_slices=len(x_train),
        twins=twins)
    return by_path


def _shares(row):
    return [row[k] for k in ("flop_share", "byte_share") if k in row]


def phase_probes():
    """probes: cmrtpu_torch.tools.roofline --steps 5 (batch 128),
    probe2d --base --set GROUP_NORM=16 and probe3d --only
    base,remat1,remat_full,bn_bf16 --steps 3 --warmup 2, in process: no
    row with an error, every share of the card's peaks at most 1."""
    from cmrtpu_torch.tools import probe2d, probe3d, roofline

    rows = {"roofline": roofline.main(["--steps", "5"]),
            "probe2d": probe2d.main(["--base", "--set", "GROUP_NORM=16"])}
    rows["probe3d"] = probe3d.main(["--only", ",".join(PROBE3D_ROWS),
                                    "--steps", "3", "--warmup", "2"])
    shares = _shares(rows["roofline"]) + _shares(
        rows["probe2d"]["roofline"]) + _shares(
        rows["probe2d"]["base_roofline"]) + _shares(
        rows["probe3d"]["roofline:base"])
    errors = {n: r["error"] for n, r in rows["probe3d"].items()
              if "error" in r}
    log("skip-list/probes", **{k: v for k, v in rows.items()})
    check(not errors, f"probes: rows with an error {errors}")
    check(set(rows["probe3d"]) == {*PROBE3D_ROWS, "roofline:base"},
          f"probes: probe3d rows {sorted(rows['probe3d'])}")
    check(len(shares) == 8 and all(0 < v <= 1.0 for v in shares),
          f"probes: shares {shares}")


def phase_skip_list(cine, train):
    """The skip-list phase's card-only parts: remat, bn-bf16, probes (ws
    runs inside the train phase, on its cohort). Returns the launches by
    path."""
    t0 = time.perf_counter()
    by_path = {"skip_list_remat": phase_remat(cine, train)}
    t1 = time.perf_counter()
    phase_bn_bf16()
    t2 = time.perf_counter()
    _reset_all()
    phase_probes()
    check(_counts() == {"k1": 0, "k2": 0, "cc3d": 0},
          f"probes: launches {_counts()}")
    log("skip-list", remat_s=t1 - t0, bn_bf16_s=t2 - t1,
        probes_s=time.perf_counter() - t2)
    return by_path


# -- slice 4, rest: the hybrids, the (2+1)D U-Net and deep supervision ------

# forward-hybrid: each MODEL_VARIANT of the cine template (and the template
# with deep supervision) at its published widths, batch FWD3D_BATCH, card
# bf16 and card f32 (TF32 off) against float64 on the card. bf16 bounds
# (max, mean) per case at ~2x the error measured on an H100 (700 W) in a
# probe: wrapper 0.068 / 0.0054, followed 0.214 / 0.021, concat 0.060 /
# 0.0060, avg 0.0030 / 0.00032, avg_plain 0.011 / 0.0012, unet_2p1d
# 0.833 / 0.062, supervision 0.096 / 0.0068 (PERF.md). The (2+1)D net's
# bf16 output is cmrtpu's (tests/test_torch_hybrids.py holds the two within
# 2e-2): its blocks leave channels dead after the middle ReLU, whose
# BatchNorm (variance 0 + eps) magnifies bf16 rounding about 30x; so its
# max bound is void and only its mean bounds it. Every control
# must fail its case's f32 bound, and its bf16 bounds but those named in
# HYBRID_UNHELD, whose faults bf16 rounding hides at a random init (their
# errors are logged)
HYBRID_BF16 = {"wrapper": (0.14, 0.011), "followed": (0.43, 0.042),
               "concat": (0.12, 0.012), "avg": (0.006, 0.00064),
               "avg_plain": (0.0225, 0.0024), "unet_2p1d": (1.0, 0.124),
               "supervision": (0.19, 0.0135)}
HYBRID_UNHELD = {"followed": ("no_norm_unet_3d.ConvBlock_1",),
                 "concat": ("no_norm_unet_3d.ConvBlock_1",),
                 "unet_2p1d": ("no_norm_ConvBlock_1",
                               "no_mid_act_ConvBlock_1")}
# wrapper's output against its 2D trunk slice by slice, f32 with TF32 off
# (cuDNN may pick another algorithm for a batch of 2 than of 16 slices)
SLICEWISE_ATOL = 1e-4
# softmax outputs (f32 heads) sum to 1
SOFTMAX_SUM_ATOL = 1e-5
# train-hybrid: fitted, restored and timed as train-3d; then one timed
# step each of the other two hybrids
TRAIN_HYBRIDS = ("wrapper", "avg", "unet_2p1d")
STEP_HYBRIDS = ("followed", "concat")


def _hybrid_case(cine, name):
    """(config, supervision) of a forward-hybrid case."""
    if name == "supervision":
        return dict(cine), True
    return dict(cine, MODEL_VARIANT=name), False


def _as_float64(model):
    """``model`` evaluated in float64: parameters, buffers and every
    module's compute dtype."""
    model.double()
    for mod in model.modules():
        if hasattr(mod, "dtype"):
            mod.dtype = torch.float64
    return model


def _without_mid_act(model, block):
    """A copy of ``model`` whose (2+1)D ConvBlock ``block`` skips the
    activation between its spatial and temporal convs."""
    control = copy.deepcopy(model)
    blk = control.get_submodule(block)
    act = blk.act

    def conv(x):
        blk.act = lambda y: y
        try:
            return type(blk)._conv(blk, x)
        finally:
            blk.act = act

    blk._conv = conv
    return control


def _folded_zb(model):
    """A copy of the hybrid ``model`` that folds z into the batch in
    [Z, B] order and restacks as [B, Z]: each slice's output lands at
    another example's or depth's place."""
    control = copy.deepcopy(model)

    def slice_forward(x, generator=None):
        b, z = x.shape[:2]
        y = control.unet_2d(x.transpose(0, 1).reshape(b * z, *x.shape[2:]))
        return y.reshape(b, z, *y.shape[1:])

    control._slice_forward = slice_forward
    return control


def _hybrid_controls(model, name, x):
    """Forwards of faulty copies of ``model`` on ``x``: a constant 0.5, a
    norm skipped in the bottleneck of each trunk and in the 3D trunk's
    first block, z folded in [Z, B] order, and per case a fault of its own
    (no middle activation in a (2+1)D block, no supervision gate, no
    head_avg)."""
    out = {"constant_0.5": lambda: torch.full(
        (*x.shape[:-1], 2), 0.5, device=x.device)}
    blocks = ["ConvBlock_1"]
    if name in HYBRIDS:
        blocks = ["unet_2d.ConvBlock_1"]
        out["z_folded_as_zb"] = lambda: _folded_zb(model)(x)
    if name in HYBRIDS and name != "wrapper":
        blocks += ["unet_3d.ConvBlock_1", "unet_3d.DownBlock_0.ConvBlock_0"]
    for block in blocks:
        out[f"no_norm_{block}"] = lambda b=block: _without_norm(model, b)(x)
    if name == "unet_2p1d":
        for block in ("DownBlock_0.ConvBlock_0", "ConvBlock_1"):
            out[f"no_mid_act_{block}"] = \
                lambda b=block: _without_mid_act(model, b)(x)
    if name == "supervision":
        def ungated():
            control = copy.deepcopy(model)
            control.supervision = False
            return control(x)
        out["no_supervision_gate"] = ungated
    if name == "avg":
        def no_head_avg():
            control = copy.deepcopy(model)
            control.final_conv = False
            return control(x)
        out["no_head_avg"] = no_head_avg
    return out


def phase_forward_hybrid(cine, name):
    """One MODEL_VARIANT of the cine template (or the template with deep
    supervision) at its published widths, BatchNorm averages from one
    batch: card f32 (TF32 off) and bf16 against float64 on the card within
    the case's bounds, which every control must fail (bf16: but those in
    HYBRID_UNHELD); softmax outputs sum to 1; the wrapper equals its 2D
    trunk slice by slice."""
    cfg, supervision = _hybrid_case(cine, name)
    bf16_max, bf16_mean = HYBRID_BF16[name]
    unheld = HYBRID_UNHELD.get(name, ())
    phase = "forward-hybrid"
    with _tf32_off():
        f32_cfg = dict(cfg, MIXED_PRECISION=False)
        x = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
            (FWD3D_BATCH, *cfg["DIM"], 1)).astype(np.float32)).cuda()
        card_f32 = _calibrate_bn(get_model(f32_cfg, supervision)
                                 .reset_parameters(
                                     torch.Generator().manual_seed(SEED))
                                 .cuda(), x)
        model = get_model(cfg, supervision).cuda().eval()
        model.load_state_dict(card_f32.state_dict())
        ref = get_model(f32_cfg, supervision).cuda().eval()
        ref.load_state_dict(card_f32.state_dict())
        _as_float64(ref)
        with torch.inference_mode():
            want = ref(x.double()).float().cpu().numpy()
            bf16 = model(x).cpu().numpy()
            f32 = card_f32(x).cpu().numpy()
            ms = cuda_ms(lambda: model(x), 5)
            ms_f64 = cuda_ms(lambda: ref(x.double()), 1)
            controls = {
                prec: {k: _errors(fn().float().cpu().numpy(), want)
                       for k, fn in _hybrid_controls(m, name, x).items()}
                for prec, m in (("bf16", model), ("f32", card_f32))}
            slicewise = None
            if name == "wrapper":
                per_slice = torch.stack([card_f32.unet_2d(x[:, z])
                                         for z in range(x.shape[1])], dim=1)
                slicewise = float((card_f32(x) - per_slice).abs().max())
    shape = (FWD3D_BATCH, *cfg["DIM"], 2)
    check(bf16.shape == shape and np.isfinite(bf16).all(),
          f"{phase} {name}: bad output {bf16.shape}")
    err, f32_err = _errors(bf16, want), _errors(f32, want)
    sum_err = None
    if name in HYBRIDS and name != "wrapper":
        sum_err = float(np.abs(bf16.sum(-1) - 1.0).max())
    log(phase, case=name, batch=FWD3D_BATCH, dim=cfg["DIM"], ms=ms,
        f64_ms=ms_f64, f32_vs_f64=f32_err, bf16_vs_f64=err,
        controls_bf16_vs_f64=controls["bf16"],
        controls_f32_vs_f64=controls["f32"],
        bounds={"f32_max": F32_3D_ATOL, "bf16_max": bf16_max,
                "bf16_mean": bf16_mean}, controls_not_held=list(unheld),
        softmax_sum_err=sum_err, wrapper_vs_slicewise_f32=slicewise)
    check(f32_err["max"] <= F32_3D_ATOL,
          f"{phase} {name}: card f32 max {f32_err['max']} > {F32_3D_ATOL}")
    check(err["max"] <= bf16_max and err["mean"] <= bf16_mean,
          f"{phase} {name}: card bf16 {err} outside ({bf16_max}, "
          f"{bf16_mean})")
    for control, e in controls["f32"].items():
        check(e["max"] > F32_3D_ATOL,
              f"{phase} {name}: f32 control {control} {e} passes the f32 "
              "bound")
    for control, e in controls["bf16"].items():
        check(control in unheld or e["max"] > bf16_max
              or e["mean"] > bf16_mean,
              f"{phase} {name}: control {control} {e} passes the bf16 "
              "bounds, which therefore cannot tell it from bf16 rounding")
    check(sum_err is None or sum_err <= SOFTMAX_SUM_ATOL,
          f"{phase} {name}: softmax sums off 1 by {sum_err}")
    check(slicewise is None or slicewise <= SLICEWISE_ATOL,
          f"{phase} wrapper: {slicewise} from its 2D trunk slice by slice")


def phase_train_hybrid(cine, train, val, work):
    """wrapper, avg and unet_2p1d on the cine template at its widths,
    EPOCHS 2, as train-3d (``_fit_cine``); then followed and concat take
    one timed step each after one warm step, K1 once a step. Returns the
    launches by path."""
    by_path = {}
    for variant in TRAIN_HYBRIDS:
        cfg = dict(cine, EPOCHS=2, MODEL_VARIANT=variant)
        launches, fields = _fit_cine(cfg, train, val,
                                     f"train-hybrid-{variant}", work)
        log("train-hybrid", **fields)
        by_path[f"train_hybrid_{variant}"] = launches
    for variant in STEP_HYBRIDS:
        trainer = Trainer(dict(cine, MODEL_VARIANT=variant), device="cuda")
        loop = DeviceCachedLoop(trainer, train)
        idx = torch.from_numpy(loop._epoch_indices(loop.n_train,
                                                   False)).cuda()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        step_ms = _warm_step_ms(lambda: loop.train_step(idx[0]), reps=1,
                                warm=1)
        launches = _counts()
        check(launches == {"k1": 2, "k2": 0, "cc3d": 0},
              f"train-hybrid {variant}: launches {launches} for 2 steps")
        log("train-hybrid", variant=variant, batch=loop.batch,
            steps=2, timed_steps=1, launches=launches, step_ms=step_ms,
            frames_per_s=loop.batch * CINE_T / (step_ms / 1e3),
            peak_memory_bytes_steps=torch.cuda.max_memory_allocated())
        by_path[f"step_hybrid_{variant}"] = launches
        del loop, trainer
        torch.cuda.empty_cache()
    return by_path


def phase_supervision(cfg, work, gen, val_gen):
    """The flagship through Trainer(cfg, supervision=True).fit_cached for
    one epoch on the phantom cohort: K1 once per train and eval step; the
    model.npz it saves restores through Predictor with the supervision
    branch, equal to Trainer.predict bit for bit. Returns the launches by
    path."""
    trainer = Trainer(cfg, device="cuda", supervision=True)
    check(trainer.model.supervision, "supervision: no branch built")
    batch = int(cfg["BATCHSIZE"])
    n_train, n_val = len(gen._cache_x), len(val_gen._cache_x)
    steps, eval_steps = n_train // batch, -(-n_val // batch)
    _reset_counts()
    t0 = time.perf_counter()
    hist = trainer.fit_cached(gen, val_gen, epochs=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _counts()
    check(launches == {"k1": steps + eval_steps, "k2": 0, "cc3d": 0},
          f"supervision: launches {launches} for {steps} train and "
          f"{eval_steps} eval steps")
    check(np.isfinite(hist[0]["loss"]) and np.isfinite(hist[0]["val_loss"]),
          f"supervision: history {hist}")
    model_dir = os.path.join(work, "supervision", "model")
    save_weights(model_dir, trainer.serving_params)
    pred = Predictor(cfg, model_dir, device="cuda")
    check(pred.model.supervision,
          "supervision: the Predictor built no supervision branch")
    x = np.random.default_rng(SEED).standard_normal(
        (8, H, W, 1)).astype(np.float32)
    probs = trainer.predict(x)
    served = pred.predict(x)
    check(np.array_equal(served, probs),
          "supervision: the restored Predictor differs from Trainer.predict "
          f"by {float(np.abs(served - probs).max())}")
    log("supervision", train_steps=steps, eval_steps=eval_steps,
        launches=launches, fit_s=fit_s,
        history={k: hist[0][k] for k in ("loss", "val_loss", "val_loc_mm")},
        predict_equal_restored=True)
    del trainer, pred
    torch.cuda.empty_cache()
    return {"supervision": launches}


# -- the last public pieces: ConvEncoder/ConvDecoder, the single-mask and
# host CC filters, the device inventory -------------------------------------

class ComposedUNet(torch.nn.Module):
    """A custom model composed of the port's blocks, as a user of
    ConvEncoder/ConvDecoder builds one: ConvEncoder(DEPTH, FILTERS,
    GroupNorm), ConvDecoder(DEPTH, FILTERS * 2 ** (DEPTH - 1), GroupNorm,
    the flagship decoder's dropouts in its forward order), a 1x1 head in
    float32 and a sigmoid. Its state_dict is the flagship U-Net's renamed
    (``_as_composed``), so on the same weights it computes the flagship's
    function."""

    def __init__(self, cfg):
        super().__init__()
        depth, filters = int(cfg["DEPTH"]), int(cfg["FILTERS"])
        drops = dropout_schedule(cfg)
        self.dtype = torch.bfloat16 if cfg["MIXED_PRECISION"] \
            else torch.float32
        kw = dict(group_norm=int(cfg["GROUP_NORM"]),
                  batch_norm=bool(cfg["BATCH_NORMALISATION"]),
                  dtype=self.dtype)
        self.ConvEncoder_0 = ConvEncoder(
            depth=depth, filters=filters, dropouts=drops,
            drop_bottleneck=float(cfg["DROPOUT_MAX"]), **kw)
        self.ConvDecoder_0 = ConvDecoder(
            depth=depth, filters=filters * 2 ** (depth - 1),
            dropouts=drops[::-1], **kw)
        self.Conv_0 = torch.nn.Conv2d(filters, int(cfg["MASK_CLASSES"]), 1)

    def forward(self, x, generator=None):
        enc, skips = self.ConvEncoder_0(x, generator)
        y = torch.movedim(self.ConvDecoder_0(enc, skips, generator), -1, 1)
        y = self.Conv_0(y.to(wide_dtype(self.dtype)))
        return torch.movedim(torch.sigmoid(y), 1, -1)


def _as_composed(state_dict):
    """The flagship U-Net's state_dict under ComposedUNet's names: the
    DownBlocks and the bottleneck in ConvEncoder_0, the UpBlocks in
    ConvDecoder_0, the head as Conv_0."""
    out = {}
    for name, tensor in state_dict.items():
        if name.startswith(("DownBlock_", "ConvBlock_")):
            name = "ConvEncoder_0." + name
        elif name.startswith("UpBlock_"):
            name = "ConvDecoder_0." + name
        elif name.startswith("head."):
            name = "Conv_0." + name[len("head."):]
        out[name] = tensor
    return out


def _composed_forward(cfg, model):
    """The composed model's bf16 forward at batch BATCHSIZE against its
    float64 evaluation on the card and against the flagship U-Net on the
    same weights; controls with a GroupNorm skipped must fail the forward
    phase's bounds."""
    flagship = build_model(cfg).reset_parameters(
        torch.Generator().manual_seed(SEED)).eval()
    model.load_state_dict(_as_composed(flagship.state_dict()))
    batch = int(cfg["BATCHSIZE"])
    x = np.random.default_rng(SEED + 15).standard_normal(
        (batch, H, W, 1)).astype(np.float32)
    model.cuda().eval()
    flagship.cuda()
    with torch.inference_mode(), _tf32_off():
        xd = torch.from_numpy(x).cuda()
        bf16 = model(xd).float().cpu().numpy()
        same = flagship(xd).float().cpu().numpy()
        ref = _as_float64(copy.deepcopy(model))(xd.double()).cpu().numpy()
        ms = cuda_ms(lambda: model(xd), 20)
        flagship_ms = cuda_ms(lambda: flagship(xd), 20)
        controls = {"constant_0.5": _errors(np.full_like(ref, 0.5), ref)}
        depth = int(cfg["DEPTH"])
        for block in ("ConvEncoder_0.ConvBlock_1",
                      f"ConvDecoder_0.UpBlock_{depth - 1}.ConvBlock_1"):
            out = _without_norm(model, block)(xd).float().cpu().numpy()
            controls[f"no_norm_{block}"] = _errors(out, ref)
    check(np.isfinite(bf16).all() and bf16.shape == (batch, H, W, 2),
          f"surface: bad composed output {bf16.shape}")
    err, vs_flagship = _errors(bf16, ref), _errors(bf16, same)
    bounds = {"bf16_max": BF16_MAX_ATOL, "bf16_mean": BF16_MEAN_ATOL}
    fig = {"batch": batch, "ms": ms, "flagship_ms": flagship_ms,
           "bf16_vs_float64": err, "controls_vs_float64": controls,
           "bounds": bounds, "vs_flagship_same_weights": vs_flagship}
    check(vs_flagship["max"] <= COMPOSED_SAME_ATOL,
          f"surface: the composed model differs from the flagship U-Net on "
          f"its weights by {vs_flagship}")
    check(err["max"] <= BF16_MAX_ATOL and err["mean"] <= BF16_MEAN_ATOL,
          f"surface: composed bf16 {err} outside the bounds {bounds}")
    for name, c in controls.items():
        check(c["max"] > BF16_MAX_ATOL or c["mean"] > BF16_MEAN_ATOL,
              f"surface: control {name} {c} passes the bf16 bounds")
    del flagship
    return fig


def _largest_2d_on_card(cases):
    """largest_component_2d of every slice of the k2 phase's cases on the
    card (one K2 launch each), then held against largest_component_batch
    on the card and the host filter's kept pixels. Returns the slices and
    the launches of the single-mask calls."""
    got, n = {}, 0
    _reset_counts()
    for name, masks in cases.items():
        dev = torch.from_numpy(masks).cuda()
        got[name] = [cc.largest_component_2d(dev[i]) for i in range(len(dev))]
        n += len(dev)
    torch.cuda.synchronize()
    launches = _counts()
    check(launches == {"k1": 0, "k2": n, "cc3d": 0},
          f"surface: largest_component_2d launched {launches} over {n} "
          "slices")
    for name, masks in cases.items():
        batch = cc.largest_component_batch(
            torch.from_numpy(masks).cuda()).cpu().numpy()
        host = cc.clean_3d_prediction_2d_cc_host(masks.astype(np.uint8)) > 0
        one = np.stack([m.cpu().numpy() for m in got[name]])
        check(np.array_equal(one, batch) and np.array_equal(one, host),
              f"surface: largest_component_2d on {name} != the batch or the "
              "host filter")
    return n, launches


def _host_filters_on_card(k2_masks, cc3d_masks):
    """The host filters against the card's: clean_3d_prediction_2d_cc_host
    = clean_prediction_2d_cc (K2) on the k2 phase's cases, and
    clean_3d_prediction_3d_cc_host = clean_prediction_3d_cc (the 3D
    kernel) on each volume of the cc3d phase's, exactly; the landmark-like
    stacks as label volumes of both values. Full slices and volumes have no
    background: both keep them. Returns the volumes compared."""
    def labels(stack, n):  # label 1's n masks, then label 2's
        lab = stack[:n].astype(np.uint8)
        lab[stack[n:]] = 2
        return lab

    vols2 = {name: m.astype(np.uint8) for name, m in k2_masks.items()}
    vols2["landmark-like"] = labels(k2_masks["landmark-like"],
                                    len(k2_masks["landmark-like"]) // 2)
    for name, vol in vols2.items():
        host = cc.clean_3d_prediction_2d_cc_host(vol)
        card = cc.clean_prediction_2d_cc(torch.from_numpy(vol).cuda())
        check(np.array_equal(host, card.cpu().numpy()),
              f"surface: 2D host filter != K2's filter on {name}")
    vols3 = {f"{name}[{i}]": v.astype(np.uint8)
             for name, stack in cc3d_masks.items() if name != "landmark-like"
             for i, v in enumerate(stack)}
    vols3["landmark-like"] = labels(cc3d_masks["landmark-like"], 1)[0]
    for name, vol in vols3.items():
        host = cc.clean_3d_prediction_3d_cc_host(vol)
        card = cc.clean_prediction_3d_cc(torch.from_numpy(vol).cuda())
        check(np.array_equal(host, card.cpu().numpy()),
              f"surface: 3D host filter != the 3D kernel's filter on {name}")
    full = [n for n, v in {**vols2, **vols3}.items()
            if (v != 0).all(axis=(-2, -1)).any()]
    check(full, "surface: no case has a slice without background")
    return {"2d": sorted(vols2), "3d": sorted(vols3),
            "without_background": full}


def _logged_devices():
    """show_available_devices' lines at INFO."""
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    root = logging.getLogger()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        devices = show_available_devices()
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
    return devices, [r.getMessage() for r in records]


def _step_against_flagship(trainer, cfg, gen, window=4):
    """The composed model's warm cached step against the flagship U-Net's
    on the same cohort, interleaved (``_paired_step_ms``), and each one's
    device busy ms a step over a profiled window."""
    loops = {"composed": DeviceCachedLoop(trainer, gen),
             "flagship": DeviceCachedLoop(Trainer(cfg, device="cuda"), gen)}
    idx = torch.from_numpy(loops["composed"]._epoch_indices(
        loops["composed"].n_train, False)).cuda()
    rows = iter(range(10 ** 6))

    def step(name):
        return lambda: loops[name].train_step(idx[next(rows) % len(idx)])

    figures = _paired_step_ms("composed", step("composed"), "flagship",
                              step("flagship"))
    for name in loops:
        by_kernel, wall_ms = _device_ms_by_kernel(
            lambda: [step(name)() for _ in range(window)])
        busy = sum(by_kernel.values()) / window
        figures[f"{name}_device_busy_ms_per_step"] = busy or None
        figures[f"{name}_profiled_wall_ms_per_step"] = wall_ms / window
    return figures


def phase_surface(cfg, work, gen, val_gen):
    """The last public pieces of the port on the card: (a) a composed
    model (``ComposedUNet``) held against float64, trained one epoch by
    Trainer(cfg, model=...).fit_cached with K1 once per train and eval
    step, its model.npz read back to the same outputs, its warm step
    timed against the flagship U-Net's; (b) largest_component_2d on every
    slice of the k2 phase's cases (K2 once each) against the batch and the
    host filter; (c) the host filters against the card's filters; (d)
    show_available_devices naming the card. Returns the launches by path: (a)'s and (b)'s."""
    t0 = time.perf_counter()
    cfg = dict(cfg, EPOCHS=1)
    model = ComposedUNet(cfg)
    forward = _composed_forward(cfg, model)

    trainer = Trainer(cfg, model=model, device="cuda")
    batch = int(cfg["BATCHSIZE"])
    steps = len(gen._cache_x) // batch
    eval_steps = -(-len(val_gen._cache_x) // batch)
    _reset_counts()
    hist = trainer.fit_cached(gen, val_gen, epochs=1)
    torch.cuda.synchronize()
    fit_launches = _counts()
    check(fit_launches == {"k1": steps + eval_steps, "k2": 0, "cc3d": 0},
          f"surface: the composed fit launched {fit_launches} for {steps} "
          f"train and {eval_steps} eval steps")
    check(np.isfinite(hist[0]["loss"]) and np.isfinite(hist[0]["val_loss"]),
          f"surface: history {hist}")
    model_dir = os.path.join(work, "composed", "model")
    save_weights(model_dir, trainer.serving_params)
    back = ComposedUNet(cfg)
    back.load_state_dict(flax_to_state_dict(*load_weights(model_dir)))
    x = np.random.default_rng(SEED + 16).standard_normal(
        (8, H, W, 1)).astype(np.float32)
    with torch.inference_mode():
        restored = back.cuda().eval()(torch.from_numpy(x).cuda()).cpu()
    check(np.array_equal(restored.numpy(), trainer.predict(x)),
          "surface: the composed model.npz read back gives other outputs")
    step = _step_against_flagship(trainer, cfg, gen)
    del trainer, back

    k2_masks, cc3d_masks = k2_cases(), cc3d_cases()
    slices, cc_launches = _largest_2d_on_card(k2_masks)
    # the filters' comparisons launch the 3D kernel outside any path: its
    # count (main checks it stays 0 off the CC_FILTER '3d' paths) is kept
    held = kernels.converge_labels_3d_cuda.launches
    filters = _host_filters_on_card(k2_masks, cc3d_masks)
    kernels.converge_labels_3d_cuda.launches = held

    devices, lines = _logged_devices()
    name = torch.cuda.get_device_name(0)
    check(len(devices) == torch.cuda.device_count()
          and any(name in line for line in lines),
          f"surface: show_available_devices logged {lines}, not {name}")
    launches = {k: fit_launches[k] + cc_launches[k] for k in fit_launches}
    log("surface", forward=forward, train_steps=steps,
        eval_steps=eval_steps, fit_launches=fit_launches,
        history={k: hist[0][k] for k in ("loss", "val_loss", "val_loc_mm")},
        npz_read_back_equal=True, step=step,
        largest_component_2d_slices=slices, filters_equal=filters,
        devices=lines, launches=launches,
        phase_s=time.perf_counter() - t0)
    torch.cuda.empty_cache()
    return {"surface": launches}


def scipy_clean_3d(pred, values):
    """Per label value the biggest 26-connected volume component (scipy;
    a tie keeps the smaller id, an empty label nothing); a later value
    overwrites an earlier one."""
    out = np.zeros_like(pred)
    for val in values:
        lab, n = scipy.ndimage.label(pred == val, structure=CUBE)
        if n:
            sizes = np.bincount(lab.ravel())[1:]
            out[lab == 1 + int(np.argmax(sizes))] = val
    return out


def _balls(rng, z, h, w, n, radius=3.0):
    """Landmark-like: ``n`` balls of ``radius`` px (2 px across slices)
    that span several slices, and stray voxels."""
    zz, yy, xx = np.mgrid[0:z, 0:h, 0:w]
    m = np.zeros((z, h, w), bool)
    for c in rng.integers(0, (z, h, w), (n, 3)):
        m |= ((zz - c[0]) / 0.7) ** 2 + ((yy - c[1]) ** 2 + (
            xx - c[2]) ** 2) / radius ** 2 <= 1.0
    return m | (rng.random(m.shape) < 1e-4)


def _serpentine_3d(h, w, layers):
    """The longest geodesic: a boustrophedon corridor in every other slice,
    joined by one voxel in the slice between at the end of one corridor and
    the start of the next."""
    serp = np.zeros((h, w), bool)
    for r in range(0, h, 2):
        serp[r, :] = True
        if r + 1 < h:
            serp[r + 1, -1 if (r // 2) % 2 == 0 else 0] = True
    ends = np.argwhere(serp)
    m = np.zeros((2 * layers - 1, h, w), bool)
    for j in range(layers):
        m[2 * j] = serp
        if j + 1 < layers:
            m[(2 * j + 1, *ends[-1 if j % 2 == 0 else 0])] = True
    return m


def _tile_corner_chains(z, h, w, rng):
    """Chains of 6 voxels that touch only across a cube's corner, one
    through every corner where the 3D kernel's tiles (32 columns x 8 rows x
    cc3d_geometry's depth) meet in a slice, each crossing it between its
    third and fourth voxel along one of the 4 space diagonals in turn, and
    where the volume has two tiles along z, the ones at their corners in 3D
    crossing from one to the other; a stray voxel in 1e4."""
    depth, _ = kernels.cc3d_geometry(z, h, w)
    m = np.zeros((z, h, w), bool)
    corners = [(yc, xc) for yc in range(kernels.CC3D_ROWS, h,
                                        kernels.CC3D_ROWS)
               for xc in range(kernels.CC_TILE, w, kernels.CC_TILE)]
    k = np.arange(6)
    for c, (yc, xc) in enumerate(corners):
        sy, sx = (1, -1)[c % 2], (1, -1)[c // 2 % 2]
        z0 = depth - 3 if depth < z and c % 3 == 0 else c % (z - 5)
        m[z0 + k, yc - 3 + k if sy > 0 else yc + 2 - k,
          xc - 3 + k if sx > 0 else xc + 2 - k] = True
    return m | (rng.random(m.shape) < 1e-4)


def cc3d_cases():
    """[N, Z, H, W] stacks: what CC_FILTER '3d' gives the kernel on a study
    (label 1's and label 2's masks), density 0.55, the longest geodesic,
    voxels that touch only across a cube's corner between slices, an empty
    and a full volume; and at the tiles' borders: chains through every tile
    corner, 20 slices (two tiles deep) of ragged width at density 0.3,
    corner chains on a volume ragged every way, one slice at density
    0.55."""
    rng = np.random.default_rng(SEED)
    diagonal = np.zeros((Z, H, W), bool)
    for k in range(Z):
        diagonal[k, 20 + k, 30 + k] = True          # a corner-linked chain
    for y, x in rng.integers(1, (H - 2, W - 3), (200, 2)):
        z = int(rng.integers(0, Z - 1))
        diagonal[z, y, x] = diagonal[z + 1, y + 1, x + 1] = True
        diagonal[z, y, x + 3] = True               # dx=3 from it: apart
    return {"landmark-like": np.stack([_balls(rng, Z, H, W, 6),
                                       _balls(rng, Z, H, W, 6)]),
            "random-0.55": (rng.random((1, Z, H, W)) < 0.55),
            "serpentine": _serpentine_3d(96, 96, 3)[None],
            "diagonal-singles": diagonal[None],
            "empty-full": np.stack([np.zeros((Z, H, W), bool),
                                    np.ones((Z, H, W), bool)]),
            "corner-chains": _tile_corner_chains(Z, H, W, rng)[None],
            "z20-0.3": rng.random((1, 20, 200, 190)) < 0.3,
            "ragged-corner-chains": _tile_corner_chains(19, 203, 190,
                                                        rng)[None],
            "z1-0.55": rng.random((1, 1, H, W)) < 0.55}


def phase_cc3d():
    """The 3D CC kernel against its plain version on the card and scipy's
    26-connected labels, exactly, and two launches against each other; the
    kept volumes on the card against scipy's; timed by events, a CUDA graph
    and the profiler beside the plain version and the bound."""
    results, max_err = {}, 0
    for name, masks in cc3d_cases().items():
        dev = torch.from_numpy(masks).cuda()
        got = kernels.converge_labels_3d_cuda(dev)
        again = kernels.converge_labels_3d_cuda(dev)
        plain = cc.label_components_3d(dev)
        torch.cuda.synchronize()
        err = int((got.long() - plain.long()).abs().max())
        max_err = max(max_err, err)
        check(err == 0, f"cc3d {name}: kernel != plain (max abs {err})")
        check(torch.equal(got, again), f"cc3d {name}: two launches differ")
        want = scipy_min_index_labels(masks, CUBE)
        check(np.array_equal(got.cpu().numpy(), want),
              f"cc3d {name}: kernel != scipy")
        kept = cc.largest_component_3d_batch(dev).cpu().numpy()
        check(np.array_equal(kept, np.stack([
            scipy_clean_3d(m.astype(np.uint8), (1,)) > 0 for m in masks])),
            f"cc3d {name}: kept volumes on the card != scipy's")
        slow = name in ("serpentine", "empty-full")
        ms = cuda_ms(lambda: kernels.converge_labels_3d_cuda(dev), 20)
        g_ms = graph_ms(lambda: kernels.converge_labels_3d_cuda(dev), 10)
        dev_us, by_kernel = device_us(
            lambda: kernels.converge_labels_3d_cuda(dev), 10, CC3D_KERNELS)
        plain_ms = cuda_ms(lambda: cc.label_components_3d(dev),
                           1 if slow else 3)
        results[name] = {"shape": list(masks.shape), "ms": ms,
                         "graph_ms": g_ms, "device_us": dev_us,
                         "plain_ms": plain_ms,
                         "bound_ms": _k2_bound_ms(masks.shape)}
        log("cc3d", case=name, shape=list(masks.shape),
            foreground=float(masks.mean()), exact=True, repeatable=True,
            ms=ms, graph_ms=g_ms, device_us=dev_us,
            device_us_by_kernel=by_kernel, plain_ms=plain_ms,
            bound_us=_k2_bound_ms(masks.shape) * 1e3)
    return results, max_err


class _Recorded:
    """Wraps the 3D cleaner: each call's input label volume, label values
    and output, on the host."""

    def __init__(self):
        self.calls = []

    def __call__(self, cleaner):
        def wrapped(pred_flat, label_values=(1, 2), device=None):
            out = cleaner(pred_flat, label_values, device=device)
            self.calls.append((np.asarray(pred_flat).copy(),
                               tuple(label_values), out.cpu().numpy()))
            return out
        return wrapped


def phase_cc3d_cli(fold, data_root, test_patients, work):
    """CC_FILTER '3d' on the trained flagship fold: cli.predict and
    cli.serve launch the 3D kernel once per patient-phase or study (and
    once for the engine's warm-up), K2 never; each cleaned volume equals
    scipy's 26-connected filter of the same thresholded predictions, and
    each written label volume that filter's output in the written
    geometry. Returns the launches by path."""
    fold3d = os.path.join(work, "f0_cc3d")
    shutil.copytree(fold, fold3d, ignore=shutil.ignore_patterns(
        "pred", "gt", "tensorboard_logs"))
    cfg_path = os.path.join(fold3d, "config", "config.json")
    with open(cfg_path, encoding="utf-8") as fh:
        cfg = dict(json.load(fh), CC_FILTER="3d")
    with open(cfg_path, "w", encoding="utf-8") as fh:
        json.dump(cfg, fh)
    phases = 2 * len(test_patients)
    by_path = {}

    recorded = _Recorded()
    for k in (kernels.gaussian_blur_2d_cuda, kernels.converge_labels_cuda,
              kernels.converge_labels_3d_cuda):
        k.launches = 0
    with _patched(predictor_module, "clean_prediction_3d_cc", recorded), \
            _Spans() as spans:
        predict_main(["-exp", fold3d, "-data", data_root])
    by_path["predict_cli_3d"] = {
        "k1": kernels.gaussian_blur_2d_cuda.launches,
        "k2": kernels.converge_labels_cuda.launches,
        "cc3d": kernels.converge_labels_3d_cuda.launches}
    check(by_path["predict_cli_3d"] == {"k1": phases, "k2": 0,
                                        "cc3d": phases},
          f"cc3d predict: launches {by_path['predict_cli_3d']} for {phases} "
          "patient-phases")
    logged = spans.pred_fold()["phases"]
    check(len(recorded.calls) == len(logged) == phases,
          f"cc3d predict: {len(recorded.calls)} cleaner calls")
    orig_files = sorted(glob.glob(os.path.join(
        data_root, "original", "*/*frame[0-9][0-9].nii.gz")))
    norm_cfg = normalise_config(cfg)
    removed = 0
    for span, (flat, values, out) in zip(logged, recorded.calls):
        want = scipy_clean_3d(flat, values)
        check(np.array_equal(out, want),
              f"cc3d predict {span['patient']} {span['phase']}: the cleaned "
              "volume != scipy's 26-connected filter")
        removed += int((flat != want).sum())
        orig = read_image(next(f for f in orig_files
                               if span["patient"] in f))
        written = read_image(os.path.join(
            fold3d, "pred", f"{span['patient']}_{span['phase']}_msk.nrrd"))
        check(np.array_equal(written.array, undo_generator_steps(
            want.astype(np.uint8), norm_cfg, NEAREST, orig).array),
            f"cc3d predict {span['patient']} {span['phase']}: written labels "
            "!= scipy's filter in the written geometry")

    recorded = _Recorded()
    with _patched(predictor_module, "clean_prediction_3d_cc", recorded):
        by_path["serve_3d"] = _serve_fold(
            fold3d, os.path.join(work, "serve_3d"), "serve-3d",
            {"msk": {0, 1, 2}}, kernel="cc3d")
    for flat, values, out in recorded.calls:
        check(np.array_equal(out, scipy_clean_3d(flat, values)),
              "serve-3d: a cleaned volume != scipy's 26-connected filter")
    log("cc3d-cli", predict_launches=by_path["predict_cli_3d"],
        serve_launches=by_path["serve_3d"], patient_phases=phases,
        voxels_removed_by_the_filter=removed,
        predict_ms_per_patient_phase=_ms_per_phase(logged),
        serve_cleaned_volumes=len(recorded.calls))
    return by_path


# predict-4d: an ACDC-sized cine of each test patient, 30 frames of the
# cohort's 10 slices, from its own ED and ES volumes
CINE_FRAMES = 30


def _write_cine(data_root, pid, rng):
    """Overwrite ``<pid>_4d.nii.gz`` with CINE_FRAMES frames that sweep
    the patient's ED volume to its ES volume and back (the LV's scale over
    one cycle), each with its own noise, at the cohort's geometry."""
    folder = os.path.join(data_root, "original", pid)
    ed = read_image(os.path.join(folder, f"{pid}_frame01.nii.gz"))
    es = read_image(os.path.join(folder, f"{pid}_frame12.nii.gz"))
    w = (1 - np.cos(2 * np.pi * np.arange(CINE_FRAMES) / CINE_FRAMES)) / 2
    w = w[:, None, None, None]
    cine = (1 - w) * ed.array[None] + w * es.array[None] \
        + rng.normal(0, 10.0, (CINE_FRAMES, *ed.array.shape))
    write_image(MedicalImage(array=cine.astype(np.float32),
                             spacing=tuple(ed.spacing) + (1.0,)),
                os.path.join(folder, f"{pid}_4d.nii.gz"))


class _Forwards:
    """Wraps ``Predictor.predict``: each call's output, cloned on the
    device (a host copy inside the run would fall into its forward
    span)."""

    def __init__(self):
        self.calls = []

    def __call__(self, predict):
        def wrapped(pred, x, to_host=True):
            out = predict(pred, x, to_host=to_host)
            self.calls.append(out.clone() if isinstance(out, torch.Tensor)
                              else np.copy(out))
            return out
        return wrapped

    def host(self, i):
        out = self.calls[i]
        return out.cpu().numpy() if isinstance(out, torch.Tensor) else out


def scipy_clean_2d(pred, values):
    """Per slice and label value the biggest 4-connected component
    (scipy; a tie keeps the smaller id), a later value over an earlier
    one: the reference of CC_FILTER true on a [..., H, W] stack."""
    flat = pred.reshape(-1, *pred.shape[-2:])
    out = np.zeros_like(flat)
    for k, sl in enumerate(flat):
        for val in values:
            lab, n = scipy.ndimage.label(sl == val)
            if n:
                sizes = np.bincount(lab.ravel())[1:]
                out[k][lab == 1 + int(np.argmax(sizes))] = val
    return out.reshape(pred.shape)


def _run_4d(exp, data_root):
    """cli.predict_4d on ``exp`` with every count at 0 just before it:
    the launches, the per-file spans and wall seconds, the forwards'
    outputs, the device memory: the process's peak during the call and
    what the process held at its start (the earlier phases' tensors), and
    the call's wall seconds."""
    forwards = _Forwards()
    for k in (kernels.gaussian_blur_2d_cuda, kernels.converge_labels_cuda,
              kernels.converge_labels_3d_cuda):
        k.launches = 0
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _patched(Predictor, "predict", forwards), _Spans() as spans:
        predict_4d_main(["-exp", exp, "-data", data_root])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = _counts()
    memory = {"peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "held_at_start_gb": held / 1e9}
    return launches, spans.predict_4d(), forwards, memory, wall_s


def host_threshold(probs):
    """Sigmoid channels -> uint8 labels in numpy, independent of the
    port: channel c over 0.5 -> c + 1, a later channel overwrites."""
    flat = np.zeros(probs.shape[:-1], np.uint8)
    for c in range(probs.shape[-1]):
        flat[probs[..., c] > 0.5] = c + 1
    return flat


def _check_4d_outputs(out_dir, test_patients, forwards, files, clean,
                      phase, cfg):
    """Each written cine label volume: uint8 [CINE_FRAMES, Z, *DIM],
    labels in {0, 1, 2}, the config's in-plane spacing (RESAMPLE), the
    study's z spacing, 1.0 in t; and equal to ``clean`` (scipy) of the
    recorded forward's thresholded labels. Returns per cine its written
    labels and its thresholded labels before the filter."""
    shape = (CINE_FRAMES, Z, *cfg["DIM"])
    spacing = (*reversed(cfg["SPACING"]), COHORT_SPACING[2], 1.0)
    check(len(forwards.calls) == len(files) == len(test_patients),
          f"{phase}: {len(forwards.calls)} forwards, {len(files)} spans "
          f"for {len(test_patients)} cines")
    results = []
    for i, pid in enumerate(sorted(test_patients)):
        name = f"{pid}_4d_pred.nrrd"
        check(files[i]["file"] == name, f"{phase}: span {files[i]['file']}")
        out = read_image(os.path.join(out_dir, name))
        check(out.array.dtype == np.uint8 and out.array.shape == shape,
              f"{phase} {name}: {out.array.dtype} {out.array.shape}")
        check(set(np.unique(out.array)) <= {0, 1, 2},
              f"{phase} {name}: labels {np.unique(out.array)}")
        check(np.allclose(out.spacing, spacing),
              f"{phase} {name}: spacing {out.spacing}")
        probs = forwards.host(i)
        check(probs.shape == (CINE_FRAMES * Z, *cfg["DIM"], 2),
              f"{phase} {name}: forward {probs.shape}")
        flat = host_threshold(probs).reshape(shape)
        want = clean(flat, (1, 2))
        check(np.array_equal(out.array, want),
              f"{phase} {name}: labels != scipy's filter of the same "
              "thresholded forward")
        results.append((out.array, flat))
    return results


def _at_stacked_shape(phase, masks, kernel, plain, names, structure=None):
    """A CC kernel at the stacked shape a 4D path gave it (both labels of
    every slice or frame of one cine): exact against its plain
    version and scipy, then timed by events, a CUDA graph and the profiler
    beside the plain version and the bound. These launches are not the
    path's."""
    got = kernel(masks)
    check(torch.equal(got, plain(masks)), f"{phase}: kernel != plain at "
          f"the cine's stacked {list(masks.shape)}")
    check(np.array_equal(got.cpu().numpy(), scipy_min_index_labels(
        masks.cpu().numpy(), structure)),
          f"{phase}: kernel != scipy at the cine's stacked shape")
    dev_us, by_kernel = device_us(lambda: kernel(masks), 10, names)
    return {"shape": list(masks.shape),
            "foreground": float(masks.float().mean()),
            "ms": cuda_ms(lambda: kernel(masks), 20),
            "graph_ms": graph_ms(lambda: kernel(masks), 10),
            "device_us": dev_us, "device_us_by_kernel": by_kernel,
            "plain_ms": cuda_ms(lambda: plain(masks), 2),
            "bound_ms": _k2_bound_ms(masks.shape)}


def _stage_ms(files):
    """Median ms of each predict_4d stage over the cines, and the
    forward's slices per second."""
    out = {k[:-2] + "_ms": float(np.median([f[k] for f in files])) * 1e3
           for k in ("read_s", "preprocess_s", "forward_s", "cc_s",
                     "write_s", "total_s")}
    out["forward_slices_per_s"] = float(np.median(
        [f["slices"] / f["forward_s"] for f in files]))
    return out


def _cc_split(masks, cc_ms, kernel_figures, reps=5):
    """A '3d' cine's cc_ms beside the device time of its two parts at the
    stacked [2 * T, Z, H, W]: the 3D kernel's (from ``kernel_figures``) and
    ``_keep_largest``'s, whose sizes buffer is [N, Z * H * W + 1] int64,
    each by the profiler over ``reps`` calls after a warm one."""
    labels = kernels.converge_labels_3d_cuda(masks)
    cc._keep_largest(masks, labels)
    by_kernel, _ = _device_ms_by_kernel(
        lambda: [cc._keep_largest(masks, labels) for _ in range(reps)])
    n = masks.shape[0]
    return {"cc_ms": cc_ms, "kernel_device_us": kernel_figures["device_us"],
            "keep_largest_device_us": sum(by_kernel.values()) * 1e3 / reps,
            "keep_largest_device_us_by_kernel": {
                k[:80]: v * 1e3 / reps for k, v in by_kernel.items()},
            "sizes_buffer_bytes": n * (masks[0].numel() + 1) * 8}


def phase_predict_4d(exp, fold, data_root, test_patients, work):
    """predict-4d: each test patient's cine made ACDC-sized (CINE_FRAMES x
    Z slices of 200^2), then cli.predict_4d on the trained flagship fold
    (CC_FILTER true): K2 exactly once per cine, K1 and the 3D kernel
    never; each written volume equal to scipy's per-slice filter of the
    same forward thresholded on the host, and a control with one frame's
    filter skipped unequal. K2 at the cine's stacked [2 * T * Z, 224, 224]
    against its plain version and scipy, timed. predict-4d-3d: the same on
    a copy of the fold with CC_FILTER '3d' (the 3D kernel once per cine,
    K2 never, scipy's 26-connected filter per frame), and the 3D kernel at
    the cine's stacked [2 * T, Z, 224, 224] against its plain version and
    scipy, timed, and the cine's cc_ms beside the kernel's and
    ``_keep_largest``'s device time there. Returns the launches by path
    and both kernels' figures at their stacked shapes."""
    rng = np.random.default_rng(SEED)
    for pid in sorted(test_patients):
        _write_cine(data_root, pid, rng)
    cines = len(test_patients)
    by_path = {}
    with open(os.path.join(fold, "config", "config.json"),
              encoding="utf-8") as fh:
        cfg = normalise_config(json.load(fh))

    launches, run, forwards, memory, wall_s = _run_4d(exp, data_root)
    by_path["predict_4d"] = launches
    check(launches == {"k1": 0, "k2": cines, "cc3d": 0},
          f"predict-4d: launches {launches} for {cines} cines")
    results = _check_4d_outputs(os.path.join(fold, "pred_4d"),
                                test_patients, forwards, run["files"],
                                scipy_clean_2d, "predict-4d", cfg)
    # the control: one frame's filter skipped (the frame where the filter
    # removed most) must fail the same check
    written, flat = results[0]
    per_frame = (written != flat).reshape(CINE_FRAMES, -1).sum(axis=1)
    frame = int(np.argmax(per_frame))
    control = written.copy()
    control[frame] = flat[frame]
    check(per_frame[frame] > 0 and not np.array_equal(control, written),
          "predict-4d: the control with frame "
          f"{frame}'s filter skipped passes the check")
    removed = [int((w != f).sum()) for w, f in results]

    masks = torch.from_numpy(np.concatenate(
        [flat == v for v in (1, 2)]).reshape(-1, *cfg["DIM"])).cuda()
    k2_cine = _at_stacked_shape("predict-4d", masks,
                                kernels.converge_labels_cuda,
                                cc.label_components_2d, K2_KERNELS)
    log("predict-4d", launches=launches, cines=cines,
        frames=CINE_FRAMES, slices_per_cine=CINE_FRAMES * Z, wall_s=wall_s,
        call_wall_s=run["wall_s"], ms_per_cine=_stage_ms(run["files"]),
        **memory, voxels_removed_by_the_filter=removed,
        control_frame=frame, control_voxels=int(per_frame[frame]),
        k2_at_stacked_shape=dict(k2_cine,
                                 bound_us=k2_cine["bound_ms"] * 1e3))
    del forwards, masks

    exp3d = os.path.join(work, "exp_4d_cc3d")
    fold3d = os.path.join(exp3d, "f0")
    shutil.copytree(fold, fold3d, ignore=shutil.ignore_patterns(
        "pred", "gt", "pred_4d", "tensorboard_logs"))
    cfg_path = os.path.join(fold3d, "config", "config.json")
    with open(cfg_path, encoding="utf-8") as fh:
        raw = dict(json.load(fh), CC_FILTER="3d")
    with open(cfg_path, "w", encoding="utf-8") as fh:
        json.dump(raw, fh)
    launches, run, forwards, memory, wall_s = _run_4d(exp3d, data_root)
    by_path["predict_4d_3d"] = launches
    check(launches == {"k1": 0, "k2": 0, "cc3d": cines},
          f"predict-4d-3d: launches {launches} for {cines} cines")
    results = _check_4d_outputs(
        os.path.join(fold3d, "pred_4d"), test_patients, forwards,
        run["files"], lambda flat, values: np.stack(
            [scipy_clean_3d(f, values) for f in flat]), "predict-4d-3d", cfg)
    # the 3D kernel at the stacked shape the path gave it: label 1's and
    # label 2's masks of every frame of the first cine, [2 * T, Z, H, W]
    _, flat = results[0]
    masks = torch.from_numpy(np.stack(
        [flat == v for v in (1, 2)]).reshape(-1, Z, *cfg["DIM"])).cuda()
    cc3d_cine = _at_stacked_shape("predict-4d-3d", masks,
                                  kernels.converge_labels_3d_cuda,
                                  cc.label_components_3d, CC3D_KERNELS,
                                  structure=CUBE)
    ms_per_cine = _stage_ms(run["files"])
    log("predict-4d-3d", launches=launches, cines=cines, wall_s=wall_s,
        ms_per_cine=ms_per_cine, **memory,
        voxels_removed_by_the_filter=[int((w != f).sum())
                                      for w, f in results],
        cc3d_at_stacked_shape=dict(cc3d_cine,
                                   bound_us=cc3d_cine["bound_ms"] * 1e3),
        cc_split=_cc_split(masks, ms_per_cine["cc_ms"], cc3d_cine))
    del forwards, masks
    return by_path, {"k2": k2_cine, "cc3d": cc3d_cine}


def phase_override_twin(exp, data_root, test_patients, work):
    """override-twin: predict_override_twin(exp, CC_FILTER '3d') on the
    card: K1 and the 3D kernel once per patient-phase, K2 never; each
    twin pred/ file byte-equal to the cc3d-cli copy's (the same pred_fold
    with the same config); evaluate_cv_save on the plain root and on the
    twin writes one row per patient-phase with finite distances."""
    phases = 2 * len(test_patients)
    for k in (kernels.gaussian_blur_2d_cuda, kernels.converge_labels_cuda,
              kernels.converge_labels_3d_cuda):
        k.launches = 0
    t0 = time.perf_counter()
    t_root = predict_override_twin(exp, {"CC_FILTER": "3d"}, "cc3d")
    wall_s = time.perf_counter() - t0
    launches = _counts()
    check(launches == {"k1": phases, "k2": 0, "cc3d": phases},
          f"override-twin: launches {launches} for {phases} patient-phases")
    twin = sorted(glob.glob(os.path.join(t_root, "f0", "pred", "*.nrrd")))
    cli3d = os.path.join(work, "f0_cc3d", "pred")
    check([os.path.basename(f) for f in twin] == sorted(
        os.path.basename(f) for f in glob.glob(os.path.join(cli3d, "*.nrrd")))
          and len(twin) == 2 * phases,
          f"override-twin: {len(twin)} files")
    for f in twin:
        with open(f, "rb") as a, open(os.path.join(
                cli3d, os.path.basename(f)), "rb") as b:
            check(a.read() == b.read(), f"override-twin: {f} differs from "
                  "the cc3d-cli copy's")
    rows = {}
    for name, root in (("plain", exp), ("twin", t_root)):
        t = time.perf_counter()
        table = evaluate_cv_save(root, data_root)
        dists = [r[c] for r in table for c in ("ant_dist_pred",
                                               "inf_dist_pred")]
        check(len(table) == phases and np.isfinite(dists).all(),
              f"override-twin: evaluate_cv_save on the {name} root: "
              f"{len(table)} rows, distances {dists}")
        rows[name] = {"wall_s": time.perf_counter() - t,
                      "ant_inf_dist_pred_px": dists}
    log("override-twin", launches=launches, patient_phases=phases,
        wall_s=wall_s, files_equal_to_cc3d_cli=len(twin),
        evaluate_cv_save=rows)
    return {"override_twin": launches}


# serving extras (slice 5) on the trained flagship fold: rot90 TTA, the
# exported artifact, the fold ensemble and soup, the int8 twin
EXTRA_BATCH = 16
# every new phase names its device; a rehearsal on the CPU sets "cpu"
DEV = "cuda"
# a TTA forward against the float64 mean of the same four per-rotation
# forwards (the same bf16 forwards; only the f32 sum differs)
TTA_F64_ATOL = 1e-5
# coords: a stamp centre may round the other way where a mean coordinate
# lies this close to a .5 tie
TIE = 1e-3
# ensemble: the vmapped forward (members batched into grouped convs)
# against the float64 mean of the members' own forwards, both float32 with
# TF32 off: the same math summed in other orders, 3.6e-6 on the H100 at
# 224^2 with GroupNorm 16 (the control without a member: 0.21)
ENSEMBLE_ATOL = 1e-4
# the served bf16 ensemble (cli.serve -ensemble) against the float64 mean
# of its members' bf16 forwards on the batches it served: the vmapped and
# the sequential bf16 forwards round apart by 0.022 on the H100 at batch 16
# (the float32 control without a member: 0.21)
ENSEMBLE_SERVED_ATOL = 5e-2
# the members beside the trained fold: its weights plus seeded noise of
# this share of each tensor's standard deviation
ENSEMBLE_NOISE = 0.1
ENSEMBLE_MEMBERS = 4
# fold-bn: the folded BN_FIRST copy's artifact against the unfolded live
# model, both float32 with TF32 off (cmrtpu's contract is 1e-5 on the CPU;
# cuDNN sums in other orders)
FOLD_BN_ATOL = 1e-4
# the int8 conv at the flagship's largest 2D conv and a cine 3D conv
INT8_CASES = {"flagship-2d": ((16, 32, 224, 224), (32, 32, 3, 3)),
              "cine-3d": ((1, 32, 8, 224, 224), (32, 32, 3, 3, 3))}
_SERVE_ARTIFACT = """
import json, sys
from cmrtpu_torch.cli.serve import main
from cmrtpu_torch.ops import cuda_kernels
totals = main(sys.argv[1:])
loaded = sorted(m for m in sys.modules if m.startswith("cmrtpu_torch.models")
                or m.split(".")[0] in ("jax", "cmrtpu"))
print("SERVED " + json.dumps({
    "studies": totals["studies"], "loaded": loaded,
    "k1": cuda_kernels.gaussian_blur_2d_cuda.launches,
    "k2": cuda_kernels.converge_labels_cuda.launches,
    "cc3d": cuda_kernels.converge_labels_3d_cuda.launches}))
"""


def _extra_batch(data_root, test_patients, cfg):
    """EXTRA_BATCH model-ready slices of the test patients' original
    frames, as serving preprocesses them."""
    slices = []
    for f in sorted(glob.glob(os.path.join(data_root, "original",
                                           "*/*frame[0-9][0-9].nii.gz"))):
        if any(p in f for p in test_patients):
            img = read_image(f)
            slices.append(preprocess_model_input(
                img.array, img.spacing[:2], cfg, device=DEV).cpu().numpy())
    x = np.concatenate(slices)[:EXTRA_BATCH]
    check(x.shape[0] == EXTRA_BATCH, f"extras: {x.shape[0]} slices")
    return x


def _fold_copy(fold, work, name, **overrides):
    """A copy of ``fold``'s config and model (no predictions) with config
    ``overrides``; returns its path."""
    dst = os.path.join(work, name)
    shutil.copytree(fold, dst, ignore=shutil.ignore_patterns(
        "pred", "gt", "tensorboard_logs", "*.pt"))
    path = os.path.join(dst, "config", "config.json")
    with open(path, encoding="utf-8") as fh:
        cfg = dict(json.load(fh), **overrides)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(cfg, fh)
    return dst


def _evaluate_root(root, data_root, rows_wanted, phase):
    """cli.evaluate_cv on a twin root: one df_eval.csv row per
    patient-phase; returns its wall s and prediction distances (NaN where
    a fold found no landmark)."""
    t0 = time.perf_counter()
    evaluate_main(["-exp", root, "-data", data_root])
    wall_s = time.perf_counter() - t0
    with open(os.path.join(root, "df_eval.csv"), newline="") as fh:
        rows = list(csv.DictReader(fh))
    check(len(rows) == rows_wanted,
          f"{phase}: df_eval.csv has {len(rows)} rows, want {rows_wanted}")
    return wall_s, [float(r[c] or "nan") for r in rows
                    for c in ("mdists_ant_gtpred", "mdists_inf_gtpred")]


def coords_reference(maps):
    """cmrtpu's coords combiner in float64 numpy on the K per-rotation
    maps rotated back ([N, H, W, C] each, the identity first): the
    thresholded centres, the majority vote, pass-through, the 3 x 3 rescue
    stamp (numpy's rint rounds half to even) and suppression. Returns the
    output and, per (n, c), 'pass', 'stamp', 'suppress' or 'none' and the
    mean coordinate."""
    k = len(maps)
    out = np.zeros_like(maps[0])
    kinds, means = {}, {}
    n_, h, w, c_ = maps[0].shape
    for n in range(n_):
        for c in range(c_):
            found = []
            for m in maps:
                ys, xs = np.nonzero(m[n, ..., c] > 0.5)
                found.append((ys.mean(), xs.mean()) if len(ys) else None)
            valid = [f for f in found if f is not None]
            detected = len(valid) >= (k + 1) // 2
            if found[0] is not None and detected:
                out[n, ..., c] = maps[0][n, ..., c]
                kinds[n, c] = "pass"
            elif detected:
                my, mx = np.mean(valid, axis=0)
                means[n, c] = (my, mx)
                cy, cx = int(np.rint(my)), int(np.rint(mx))
                out[n, max(cy - 1, 0):cy + 2, max(cx - 1, 0):cx + 2, c] = 1.0
                kinds[n, c] = "stamp"
            else:
                kinds[n, c] = "suppress" if found[0] is not None else "none"
    return out, kinds, means


def _check_coords(got, maps, phase):
    """``got`` against ``coords_reference(maps)``: a passed-through map
    within TTA_F64_ATOL of the identity forward, everything else equal but
    a stamp whose mean lies within TIE of a .5 tie. Returns the count of
    each outcome."""
    want, kinds, means = coords_reference(maps)
    ties = 0
    for (n, c), kind in kinds.items():
        if kind == "pass":
            check(np.abs(got[n, ..., c] - maps[0][n, ..., c]).max()
                  <= TTA_F64_ATOL, f"{phase}: ({n}, {c}) did not pass the "
                  "identity map through")
            continue
        near = kind == "stamp" and any(
            abs(abs(v - np.floor(v)) - 0.5) < TIE for v in means[n, c])
        ties += near
        check(near or np.array_equal(got[n, ..., c], want[n, ..., c]),
              f"{phase}: ({n}, {c}) {kind} differs from the float64 "
              "reference")
    return dict({k: sum(v == k for v in kinds.values())
                 for k in ("pass", "stamp", "suppress", "none")},
                stamps_near_a_tie=ties)


def _coords_combiner(hw):
    """The coords combiner on the card over designed orbit members (a
    trained fold's members may all agree): per slice and channel a blob
    jittered by member, the identity dimmed below 0.5 on slices 0-3,
    channel 0 (a rescue stamp), members 1-3 dimmed on slices 4-7, channel
    1 (suppressed), all four on slices 8-9 (nothing), held against the
    float64 reference."""
    rng = np.random.default_rng(SEED)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    maps = []
    centres = rng.uniform(20, min(h, w) - 20, (EXTRA_BATCH, 2, 2))
    for k in range(4):
        m = rng.random((EXTRA_BATCH, h, w, 2)).astype(np.float32) * 0.3
        for n in range(EXTRA_BATCH):
            for c in range(2):
                cy, cx = centres[n, c] + rng.uniform(-2, 2, 2)
                m[n, ..., c] += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                       / 8.0)
        m = np.clip(m, 0, 1)
        if k == 0:
            m[0:4, ..., 0] *= 0.4
        else:
            m[4:8, ..., 1] *= 0.4
        m[8:10] *= 0.4
        maps.append(m)
    members = [torch.as_tensor(m, device=DEV) for m in maps]
    calls = iter(range(4))

    def forward(_x):
        k = next(calls)
        return torch.rot90(members[k], k, (-3, -2))

    got = tta_rot90_coords_forward(forward, hw)(torch.zeros(
        (EXTRA_BATCH, h, w, 1), device=DEV)).cpu().numpy()
    counts = _check_coords(got, [m.astype(np.float64) for m in maps],
                           "tta coords combiner")
    check(counts["stamp"] >= 4 and counts["suppress"] >= 4,
          f"tta coords combiner: the designed branches did not occur "
          f"{counts}")
    return counts


def phase_tta(exp, fold, data_root, test_patients, work, x):
    """tta: the trained fold with TTA 'probs' and 'coords' at batch 16, each
    held against a float64 recomputation from the four per-rotation
    forwards of the plain restored model (a control that forgets to
    rotate the outputs back must fail the probs bound), and the coords
    combiner over designed members with every branch; forward ms beside
    the plain forward; cli.serve of each (K2 once per study and head, and
    once for the warm-up); predict_tta_twin of each through pred_fold and
    cli.evaluate_cv."""
    phases = 2 * len(test_patients)
    plain = Predictor(normalise_config(_fold_config(fold)),
                      os.path.join(fold, "model"), device=DEV)
    xt = torch.as_tensor(x, device=DEV)
    with torch.inference_mode():
        rot = [torch.rot90(plain.model(torch.rot90(xt, k, (-3, -2))), -k,
                           (-3, -2)).double().cpu().numpy()
               for k in range(4)]
        unrotated = np.mean([plain.model(torch.rot90(xt, k, (-3, -2)))
                             .double().cpu().numpy() for k in range(4)], 0)
    figures = {"plain_ms": cuda_ms(lambda: plain._forward(x), 10)}
    by_path = {}
    for mode in ("probs", "coords"):
        tta_fold = _fold_copy(fold, work, f"f0_tta_{mode}", TTA=True,
                              TTA_MODE=mode)
        pred = Predictor(normalise_config(_fold_config(tta_fold)),
                         os.path.join(tta_fold, "model"), device=DEV)
        got = pred.predict(x).astype(np.float64)
        if mode == "probs":
            err = float(np.abs(got - np.mean(rot, axis=0)).max())
            control = float(np.abs(unrotated - np.mean(rot, axis=0)).max())
            check(err <= TTA_F64_ATOL < control,
                  f"tta probs: {err} from the float64 mean (bound "
                  f"{TTA_F64_ATOL}); the unrotated control {control}")
            stats = {"max_abs_err": err, "control_unrotated": control}
        else:
            stats = {"model": _check_coords(got, rot, "tta coords"),
                     "combiner": _coords_combiner(x.shape[1:3])}
        ms = cuda_ms(lambda: pred._forward(x), 10)
        served = _serve_fold(tta_fold,
                             os.path.join(work, f"serve_tta_{mode}"),
                             f"serve-tta-{mode}", {"msk": {0, 1, 2}})
        by_path[f"serve_tta_{mode}"] = served
        _reset_all()
        twin = predict_tta_twin(exp, mode, device=DEV)
        twin_counts = _counts()
        check(twin_counts == {"k1": phases, "k2": phases, "cc3d": 0},
              f"tta twin {mode}: launches {twin_counts} for {phases} "
              "patient-phases")
        by_path[f"tta_twin_{mode}"] = twin_counts
        _check_predictions(os.path.join(twin, "f0"), test_patients)
        eval_s, dists = _evaluate_root(twin, data_root, phases,
                                       f"tta twin {mode}")
        figures[mode] = dict(stats, forward_ms=ms, serve_k2=served["k2"],
                             evaluate_s=eval_s, mdists_gtpred_mm=dists)
    log("tta", batch=EXTRA_BATCH, **figures)
    return by_path


def _fold_config(fold):
    with open(os.path.join(fold, "config", "config.json"),
              encoding="utf-8") as fh:
        return json.load(fh)


def _bn_first_copy(fold, work, x):
    """A BN_FIRST float32 copy of the trained fold: its convs and its
    GroupNorm affines as BatchNorm's, running averages from one batch."""
    cfg = dict(_fold_config(fold), GROUP_NORM=0, BATCH_NORMALISATION=True,
               BN_FIRST=True, MIXED_PRECISION=False)
    model = build_model(cfg)
    state = {k.replace("GroupNorm_0", "BatchNorm_0"): v for k, v in
             flax_to_state_dict(*load_weights(os.path.join(
                 fold, "model"))).items()}
    model.load_state_dict(state, strict=False)
    model = _calibrate_bn(model.to(DEV), torch.as_tensor(x, device=DEV))
    dst = os.path.join(work, "f0_bn_first")
    save_weights(os.path.join(dst, "model"), model)
    os.makedirs(os.path.join(dst, "config"))
    with open(os.path.join(dst, "config", "config.json"), "w") as fh:
        json.dump(cfg, fh)
    return dst


def phase_export(fold, work, x, swap_npz):
    """export: cli.export of the fold at batch 16, served by cli.serve
    -artifact in a fresh interpreter that imports no cmrtpu_torch.models
    (its K2 launches once per study and once for the warm-up), labels
    equal to the live fold's cli.serve; a control swaps weights.npz for
    another model's, which must change the output and equal that model's
    forward; then --fold-bn of a BN_FIRST copy, its artifact against the
    unfolded model (float32, TF32 off) and served."""
    by_path = {}
    art = os.path.join(work, "art")
    t0 = time.perf_counter()
    export_main(["-exp", fold, "-out", art, "--batch", str(EXTRA_BATCH),
                 "--device", DEV])
    export_s = time.perf_counter() - t0
    in_dir = os.path.join(work, "art_in")
    _write_studies(in_dir)
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    proc = subprocess.run(
        [sys.executable, "-c", _SERVE_ARTIFACT, "-artifact", art, "-in",
         in_dir, "-out", os.path.join(work, "art_out"), "--device", DEV],
        env=env,
        capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"export: serving the artifact failed: "
          f"{proc.stderr[-3000:]}")
    served = json.loads(next(line for line in proc.stdout.splitlines()
                             if line.startswith("SERVED "))[7:])
    check(served["loaded"] == [] and served["studies"] == len(STUDIES),
          f"export: the artifact's server {served}")
    by_path["serve_artifact"] = {k: served[k] for k in ("k1", "k2", "cc3d")}
    check(by_path["serve_artifact"] == {"k1": 0, "k2": len(STUDIES) + 1,
                                        "cc3d": 0},
          f"export: the artifact's server launched {served}")
    serve_main(["-exp", fold, "-in", in_dir, "-out",
                os.path.join(work, "live_out"), "--device", DEV])
    for name in STUDIES:
        stem = name.split(".")[0]
        a = read_image(os.path.join(work, "art_out", f"{stem}_msk_pred.nrrd"))
        b = read_image(os.path.join(work, "live_out",
                                    f"{stem}_msk_pred.nrrd"))
        check(np.array_equal(a.array, b.array) and np.allclose(
            a.spacing, b.spacing) and np.allclose(a.origin, b.origin),
            f"export: {stem} served from the artifact != the live fold's")

    pt2 = os.path.join(art, "forward.pt2")
    pt2_mb = os.path.getsize(pt2) / 1e6
    npz_mb = os.path.getsize(os.path.join(art, "weights.npz")) / 1e6
    with zipfile.ZipFile(pt2) as z:  # tensors saved in the program
        tensor_mb = sum(i.file_size for i in z.infolist()
                        if "/data/" in i.filename
                        and not i.filename.endswith(".json")) / 1e6
    check(tensor_mb < npz_mb / 100,
          f"export: forward.pt2 holds {tensor_mb} MB of tensors beside "
          f"the {npz_mb} MB of weights.npz")
    fn, meta = load_exported(art, device=DEV)
    xt = torch.as_tensor(x, device=DEV)
    with torch.inference_mode():
        before = fn(load_exported_weights(art, device=DEV), xt)
        shutil.copyfile(os.path.join(art, "weights.npz"),
                        os.path.join(work, "weights.keep"))
        shutil.copyfile(swap_npz, os.path.join(art, "weights.npz"))
        after = fn(load_exported_weights(art, device=DEV), xt)
        other = Predictor(_fold_config(fold), os.path.dirname(swap_npz),
                          device=DEV)._forward(x)
    moved = float((after - before).abs().max())
    other_err = float((after - other).abs().max())
    check(moved > 1e-2 and other_err <= 1e-6,
          f"export: a swapped weights.npz moved the output by {moved} and "
          f"lies {other_err} from its model's forward")
    shutil.copyfile(os.path.join(work, "weights.keep"),
                    os.path.join(art, "weights.npz"))

    bn_fold = _bn_first_copy(fold, work, x)
    art_bn = os.path.join(work, "art_bn")
    export_main(["-exp", bn_fold, "-out", art_bn, "--batch",
                 str(EXTRA_BATCH), "--fold-bn", "--device", DEV])
    with _tf32_off(), torch.inference_mode():
        fn_bn, _ = load_exported(art_bn, device=DEV)
        folded = fn_bn(load_exported_weights(art_bn, device=DEV), xt)
        live = Predictor(_fold_config(bn_fold), os.path.join(
            bn_fold, "model"), device=DEV)._forward(x)
    bn_err = float((folded - live).abs().max())
    check(bn_err <= FOLD_BN_ATOL,
          f"export: the folded artifact lies {bn_err} from the unfolded "
          f"model (bound {FOLD_BN_ATOL})")
    check(not any(k.startswith("batch_stats/") for k in
                  np.load(os.path.join(art_bn, "weights.npz")).files),
          "export: the folded weights keep batch statistics")
    by_path["serve_artifact_bn"] = _serve_fold(
        art_bn, os.path.join(work, "serve_art_bn"), "serve-artifact-bn",
        {"msk": {0, 1, 2}}, source="-artifact")
    log("export", export_s=export_s, x_shape=meta["x_shape"],
        device=meta["device"], forward_pt2_mb=pt2_mb,
        forward_pt2_tensor_mb=tensor_mb, weights_npz_mb=npz_mb,
        served=served,
        swapped_weights_moved=moved, swapped_vs_its_model=other_err,
        fold_bn_max_abs_err=bn_err,
        fold_bn_serve_k2=by_path["serve_artifact_bn"]["k2"])
    return by_path


def _noisy_member(fold, dst, seed):
    """The fold's weights plus seeded noise as ``dst/model``; returns the
    model dir."""
    params, stats = load_weights(os.path.join(fold, "model"))
    rng = np.random.default_rng(seed)
    noisy = {}
    for key, arr in _flatten(params).items():
        noisy[key] = (arr + rng.normal(0.0, ENSEMBLE_NOISE * float(arr.std())
                                       + 1e-6, arr.shape)).astype(arr.dtype)
    model_dir = os.path.join(dst, "model")
    save_weights(model_dir, flax_to_state_dict(_unflatten(noisy), stats))
    return model_dir


def _ensemble_root(fold, work):
    """exp/ts with f0 the trained fold and f1.. its noisy copies, each with
    FOLD k (the cohort's 4 folds, so the soup twin is a whole CV)."""
    root = os.path.join(work, "ens", "ts")
    cfg = _fold_config(fold)
    for k in range(ENSEMBLE_MEMBERS):
        dst = os.path.join(root, f"f{k}")
        os.makedirs(os.path.join(dst, "config"))
        if k == 0:
            shutil.copytree(os.path.join(fold, "model"),
                            os.path.join(dst, "model"),
                            ignore=shutil.ignore_patterns("*.pt"))
        else:
            _noisy_member(fold, dst, SEED + k)
        with open(os.path.join(dst, "config", "config.json"), "w") as fh:
            json.dump(dict(cfg, FOLD=k, EXP_PATH=dst,
                           MODEL_PATH=os.path.join(dst, "model")), fh)
    return root


def _recording(served):
    """A wrapper of ``EnsemblePredictor._forward`` that appends each
    call's input and its output (float64, on the host) to ``served``."""
    def wrap(forward):
        def wrapped(self, x):
            out = forward(self, x)
            served.append((np.array(torch.as_tensor(x).cpu()),
                           out.double().cpu()))
            return out
        return wrapped
    return wrap


def phase_ensemble(fold, data_root, work, x):
    """ensemble: the trained fold and three noisy copies as a CV root.
    EnsemblePredictor's one vmapped forward (float32) against the mean of
    the members' Predictor forwards; its ms against four sequential
    forwards; cli.serve -ensemble, every batch its engine forwarded held
    against the mean of the members' bf16 forwards on that batch (each
    bound with a control without the last member, which must fail it);
    soup_experiment and cli.evaluate_cv on the soup root."""
    root = _ensemble_root(fold, work)
    dirs = [os.path.join(root, f"f{k}", "model")
            for k in range(ENSEMBLE_MEMBERS)]

    def mean_and_members(cfg):
        ens = EnsemblePredictor(cfg, dirs, device=DEV)
        members = [Predictor(cfg, d, device=DEV) for d in dirs]
        with torch.inference_mode():
            outs = [m._forward(x).double() for m in members]
            return ens, members, ens._forward(x).double(), outs

    with _tf32_off():
        _, _, got, outs = mean_and_members(dict(_fold_config(fold),
                                                MIXED_PRECISION=False))
    want = torch.stack(outs).mean(0)
    err = float((got - want).abs().max())
    control = float((torch.stack(outs[:-1]).mean(0) - got).abs().max())
    check(err <= ENSEMBLE_ATOL < control,
          f"ensemble: the f32 ensemble lies {err} from its members' mean "
          f"(bound {ENSEMBLE_ATOL}); the control without a member {control}")
    ens, members, got16, outs16 = mean_and_members(_fold_config(fold))
    bf16_err = float((got16 - torch.stack(outs16).mean(0)).abs().max())
    batched_ms = cuda_ms(lambda: ens._forward(x), 5)
    sequential_ms = cuda_ms(lambda: [m._forward(x) for m in members], 5)
    served = []
    with _patched(EnsemblePredictor, "_forward", _recording(served)):
        by_path = {"serve_ensemble": _serve_fold(
            root, os.path.join(work, "serve_ens"), "serve-ensemble",
            {"msk": {0, 1, 2}}, source="-ensemble")}
    # the warm-up and a study's Z slices in batches of BATCHSIZE
    batches = 1 + len(STUDIES) * -(-Z // int(_fold_config(fold)["BATCHSIZE"]))
    check(len(served) == batches, f"ensemble: the served engine forwarded "
          f"{len(served)} batches, want {batches}")
    served_err = served_control = 0.0
    with torch.inference_mode():
        for xs, out in served:
            ref = torch.stack([m._forward(xs).double().cpu()
                               for m in members])
            served_err = max(served_err,
                             float((out - ref.mean(0)).abs().max()))
            served_control = max(served_control,
                                 float((out - ref[:-1].mean(0)).abs().max()))
    check(served_err <= ENSEMBLE_SERVED_ATOL < served_control,
          f"ensemble: cli.serve -ensemble lies {served_err} from its "
          f"members' bf16 mean (bound {ENSEMBLE_SERVED_ATOL}); the control "
          f"without a member {served_control}")
    _reset_all()
    t0 = time.perf_counter()
    soup_root = soup_experiment(root, device=DEV)
    soup_s = time.perf_counter() - t0
    folds = ENSEMBLE_MEMBERS
    by_path["soup_pred_fold"] = _counts()
    check(by_path["soup_pred_fold"] == {"k1": 4 * folds, "k2": 4 * folds,
                                        "cc3d": 0},
          f"soup: launches {by_path['soup_pred_fold']} for {folds} folds of "
          "4 patient-phases")
    eval_s, dists = _evaluate_root(soup_root, data_root, 4 * folds, "soup")
    log("ensemble", members=ENSEMBLE_MEMBERS, batch=EXTRA_BATCH,
        f32_max_abs_err=err, f32_mean_abs_err=float(
            (got - want).abs().mean()), control_without_a_member=control,
        bf16_max_abs_err=bf16_err, served_max_abs_err=served_err,
        served_control_without_a_member=served_control,
        batched_ms=batched_ms, sequential_ms=sequential_ms,
        serve_k2=by_path["serve_ensemble"]["k2"], soup_s=soup_s,
        soup_evaluate_s=eval_s, soup_mdists_gtpred_mm=dists)
    return by_path


def phase_int8(exp, fold, data_root, work, x):
    """int8: the int8 conv against its float64 plain version, bit for bit,
    at the flagship's largest 2D conv and a cine 3D conv (timed beside the
    plain version and a bf16 cuDNN conv); quantize_fold on the fold's
    training slices, pred_fold and cli.evaluate_cv of the twin; the twin's
    |delta prob| against the float fold; cli.export --int8 served through
    -artifact; forward ms int8 against bf16 at batch 16 (recorded, not
    gated)."""
    from cmrtpu_torch.ops.int8_conv import int8_conv, int8_conv_plain

    gen = torch.Generator(DEV).manual_seed(SEED)
    convs = {}
    for name, (shape, kshape) in INT8_CASES.items():
        q = torch.randint(-127, 128, shape, dtype=torch.int8, device=DEV,
                          generator=gen)
        w = torch.randint(-127, 128, kshape, dtype=torch.int8,
                          device=DEV, generator=gen)
        got, want = int8_conv(q, w), int8_conv_plain(q, w)
        check(torch.equal(got, want), f"int8 {name}: the int8 conv != its "
              "float64 plain version")
        conv = F.conv2d if len(shape) == 4 else F.conv3d
        qb, wb = q.bfloat16(), w.bfloat16()
        convs[name] = {
            "shape": list(shape), "kernel": list(kshape),
            "ms": cuda_ms(lambda: int8_conv(q, w), 5),
            "plain_ms": cuda_ms(lambda: int8_conv_plain(q, w), 2),
            "bf16_cudnn_ms": cuda_ms(lambda: conv(qb, wb, padding="same"), 5)}
    x_train, _, _, _ = get_trainings_files(
        os.path.join(data_root, "2D"), 0,
        os.path.join(data_root, "df_kfold.csv"))
    t0 = time.perf_counter()
    twin = quantize_fold(fold, x_train, batch=EXTRA_BATCH, device=DEV)
    quantize_s = time.perf_counter() - t0
    qcfg = _fold_config(twin)
    check(qcfg["QUANT_INT8"] is True, "int8: the twin's config")
    test = fold_patients(os.path.join(data_root, "df_kfold.csv"), 0)
    phases = 2 * len(test)
    _reset_all()
    pred_fold(qcfg, device=DEV)
    by_path = {"int8_pred_fold": _counts()}
    check(by_path["int8_pred_fold"] == {"k1": phases, "k2": phases,
                                        "cc3d": 0},
          f"int8: pred_fold launches {by_path['int8_pred_fold']}")
    _check_predictions(twin, test)
    eval_s, dists = _evaluate_root(os.path.dirname(twin), data_root, phases,
                                   "int8")
    floatp = Predictor(_fold_config(fold), os.path.join(fold, "model"),
                       device=DEV)
    twinp = Predictor(qcfg, os.path.join(twin, "model"), device=DEV)
    delta = np.abs(twinp.predict(x) - floatp.predict(x))
    check(np.isfinite(delta).all(), "int8: non-finite twin outputs")
    int8_ms = cuda_ms(lambda: twinp._forward(x), 10)
    bf16_ms = cuda_ms(lambda: floatp._forward(x), 10)
    # torch._int_mm has no vmap batching rule: an ensemble of int8 twins
    # runs it once per member, with a warning; timed here with the twin
    # twice. Its distance from the twin is logged, not held: the batched
    # GroupNorm sums in another order, and one flipped int8 step in this
    # 2-epoch twin moves a probability by up to 0.2 (0.21 at 64^2 on the
    # CPU)
    twin_model = os.path.join(twin, "model")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ens8 = EnsemblePredictor(qcfg, [twin_model, twin_model], device=DEV)
        with torch.inference_mode():
            ens8_out = ens8._forward(x)
            ens8_err = float((ens8_out - twinp._forward(x)).abs().max())
    fallback = any("_int_mm" in str(w.message) for w in caught)
    check(bool(torch.isfinite(ens8_out).all()),
          "int8: the int8 ensemble's output is not finite")
    ens8_ms = cuda_ms(lambda: ens8._forward(x), 5)
    art = os.path.join(work, "art_int8")
    calib = os.path.join(work, "calib")
    _write_studies(calib)
    export_main(["-exp", fold, "-out", art, "--batch", str(EXTRA_BATCH),
                 "--int8", "--calib", calib, "--device", DEV])
    check(np.load(os.path.join(art, "weights.npz"))[
        "params/DownBlock_0/ConvBlock_0/QuantConv_0/kernel_q"].dtype
        == np.int8, "int8: the exported weights are not int8")
    by_path["serve_artifact_int8"] = _serve_fold(
        art, os.path.join(work, "serve_art_int8"), "serve-artifact-int8",
        {"msk": {0, 1, 2}}, source="-artifact")
    log("int8", convs=convs, quantize_fold_s=quantize_s,
        calib_slices=len(x_train), twin_max_abs_dprob=float(delta.max()),
        twin_mean_abs_dprob=float(delta.mean()), int8_forward_ms=int8_ms,
        bf16_forward_ms=bf16_ms, int8_ensemble_of_2_ms=ens8_ms,
        int8_ensemble_of_2_max_abs_from_twin=ens8_err,
        int8_vmap_falls_back_per_member=fallback, evaluate_s=eval_s,
        mdists_gtpred_mm=dists,
        serve_k2=by_path["serve_artifact_int8"]["k2"])
    return by_path


def phase_serving_extras(exp, fold, data_root, test_patients, work):
    """Slice 5's serving extras on the trained fold: tta, export,
    ensemble, int8. Returns their launches by path."""
    cfg = normalise_config(_fold_config(fold))
    x = _extra_batch(data_root, test_patients, cfg)
    by_path = phase_tta(exp, fold, data_root, test_patients, work, x)
    ens_paths = phase_ensemble(fold, data_root, work, x)
    by_path.update(phase_export(
        fold, work, x, os.path.join(work, "ens", "ts", "f1", "model",
                                    "model.npz")))
    by_path.update(ens_paths)
    by_path.update(phase_int8(exp, fold, data_root, work, x))
    return by_path


# -- slice 7: the ImageWriter, profiling, the A/B tools, the quickstart -----

# an A/B tool's printed means against the means read back from the
# df_eval.csv files it names: the same float64 numbers (printed by
# repr in its JSON line), summed in another order
AB_MEAN_ATOL = 1e-9
# analyze_results' summary.csv against numpy on the same cells
SUMMARY_RTOL = 1e-12


class _Warnings(logging.Handler):
    """The root logger's records of WARNING and above while active."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def __enter__(self):
        logging.getLogger().addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger().removeHandler(self)


def _counting_forwards(calls):
    """A wrapper of ``ImageWriter.on_epoch_end`` that appends (epoch, the
    trainer's forwards in the call, the warnings logged in it) to
    ``calls`` (train_fold sets the root logger's handlers up itself, so
    the warnings are caught inside the call)."""
    def wrap(orig):
        def on_epoch_end(self, trainer, epoch, logs):
            n = [0]
            real = trainer.predict

            def counted(x):
                n[0] += 1
                return real(x)
            trainer.predict = counted
            try:
                with _Warnings() as warned:
                    orig(self, trainer, epoch, logs)
            finally:
                del trainer.predict
            calls.append((epoch, n[0],
                          [r.getMessage() for r in warned.records]))
        return on_epoch_end
    return wrap


def _timed(walls):
    """A wrapper of ``DataGenerator.__init__`` that appends its wall s."""
    def wrap(orig):
        def __init__(self, *args, **kwargs):
            t0 = time.perf_counter()
            orig(self, *args, **kwargs)
            walls.append(time.perf_counter() - t0)
        return __init__
    return wrap


def _check_image_writer(fold, calls):
    """The flagship template sets SAVE_LEARNING_PROGRESS_AS_TF (frequency
    5), so the CLI fold built an ImageWriter, called after both epochs.
    Without matplotlib (this card's host has none) exactly one warning
    names it and the epoch-0 call runs no forward; with it, epoch 0 draws
    both sample batches."""
    check([c[0] for c in calls] == [0, 1],
          f"image writer: called after epochs {calls}")
    forwards = [c[1] for c in calls]
    mentions = [m for c in calls for m in c[2] if "matplotlib" in m]
    if importlib.util.find_spec("matplotlib") is None:
        check(len(mentions) == 1 and forwards == [0, 0],
              f"image writer without matplotlib: warnings {mentions}, "
              f"forwards by epoch {forwards}")
    else:
        check(not mentions and forwards == [2, 0] and all(
            os.path.exists(os.path.join(fold, "figures",
                                        f"epoch0000_{b}.png"))
            for b in ("train", "val")),
            f"image writer: warnings {mentions}, forwards {forwards}")
    return {"forwards_by_epoch": forwards, "matplotlib_warnings": mentions}


def _log_host_stage(stages, builds, fold_wall_s, pred_fold_wall_s):
    """The host stage's share of the flagship CLI fold: the train and val
    generators' builds (the deterministic stage of every slice in a
    thread pool; wall s) and the sample batches (``generator/batch``),
    beside the fold's wall s without its chained pred_fold, whose own
    generator builds are reported apart. ``generator/fix_preprocess`` sums
    the pool's threads."""
    fit_wall = fold_wall_s - pred_fold_wall_s
    host = sum(builds[:2]) + stages.get("generator/batch", {}).get(
        "total_s", 0.0)
    log("host-stage", fold_wall_s=fold_wall_s, fit_wall_s=fit_wall,
        pred_fold_wall_s=pred_fold_wall_s,
        generator_builds_s=builds[:2],
        pred_fold_generator_builds_s=sum(builds[2:]),
        stages=stages, host_stage_s=host,
        host_share_of_fit=host / fit_wall,
        host_share_of_fold=(host + sum(builds[2:])) / fold_wall_s)


def phase_profile(cfg, data_root, work):
    """profile: three warm flagship steps of the device-cached loop under
    ``profiling.trace``: the Chrome trace written under the work dir holds
    the step's own ``train.step`` span (``profiling.span``, its step
    number in the range's name) three times and K1's kernel."""
    x_tr, y_tr, _, _ = get_trainings_files(
        os.path.join(data_root, "2D"), 0,
        os.path.join(data_root, "df_kfold.csv"))
    loop = DeviceCachedLoop(Trainer(cfg, device="cuda"),
                            DataGenerator(x_tr, y_tr, config=cfg))
    idx = torch.from_numpy(loop._epoch_indices(loop.n_train, True)).cuda()
    for s in range(2):
        loop.train_step(idx[s])
    torch.cuda.synchronize()
    log_dir = os.path.join(work, "trace")
    t0 = time.perf_counter()
    with profiling.trace(log_dir):
        for s in range(3):
            loop.train_step(idx[s % len(idx)])
    wall_s = time.perf_counter() - t0
    path = os.path.join(log_dir, "trace.json")
    check(os.path.isfile(path), f"profile: no trace at {path}")
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    steps = [e for e in events
             if str(e.get("name")).split(" ")[0] == "train.step"]
    host_ranges = [e for e in steps if e.get("cat") == "user_annotation"]
    device_ranges = [e for e in steps
                     if e.get("cat") == "gpu_user_annotation"]
    blur = [e for e in events if "gaussian_blur_kernel" in str(e.get("name"))]
    check(len(host_ranges) == 3, f"profile: the trace names train.step "
          f"{len(host_ranges)} times on the host, want 3")
    check(len(blur) >= 3, f"profile: K1's kernel appears {len(blur)} times "
          "in the trace, want one per step")
    log("profile", trace_bytes=os.path.getsize(path), events=len(events),
        wall_s=wall_s, train_step_ranges=len(host_ranges),
        device_ranges=len(device_ranges), k1_kernel_events=len(blur),
        k1_kernel=str(blur[0].get("name"))[:80],
        k1_device_us=[e.get("dur") for e in blur])


def _csv_mean(path, col):
    """The NaN-skipping mean of a csv column read back with csv (an empty
    or non-numeric cell skipped)."""
    vals = []
    with open(path, newline="") as fh:
        for row in csv.DictReader(fh):
            try:
                v = float(row[col])
            except (TypeError, ValueError):
                continue
            if not np.isnan(v):
                vals.append(v)
    return float(np.mean(vals)) if vals else float("nan")


def _run_tool(main_fn, argv):
    """``main_fn(argv)`` with every kernel's count from 0 and its standard
    output captured (and echoed): (result, counts, wall s, output)."""
    _reset_all()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = main_fn(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = _counts()
    print(buf.getvalue(), end="", flush=True)
    return result, counts, wall_s, buf.getvalue()


def _hold_ab(tag, printed, rows):
    """The tool's printed JSON line: each mean equal to the mean read back
    from the df_eval.csv it names (AB_MEAN_ATOL, NaN only where both are);
    each csv holds ``rows`` rows. Returns the means and the worst gap."""
    line = json.loads([ln for ln in printed.splitlines()
                       if ln.startswith('{"means"')][-1])
    worst = 0.0
    for name, path in line["df_eval"].items():
        with open(path, newline="") as fh:
            n = sum(1 for _ in csv.DictReader(fh))
        check(n == rows, f"{tag}: {path} has {n} rows, want {rows}")
        for col, got in line["means"][name].items():
            want = _csv_mean(path, col)
            if np.isnan(got) or np.isnan(want):
                check(np.isnan(got) and np.isnan(want),
                      f"{tag}: {name} {col} printed {got}, csv {want}")
                continue
            worst = max(worst, abs(got - want))
            check(abs(got - want) <= AB_MEAN_ATOL,
                  f"{tag}: {name} {col} printed {got}, csv {want}")
    return line["means"], worst


def phase_ab_tools(exp, fold, data_root, test_patients, work):
    """ab-tools: the four A/B tools' ``main(argv)`` with --device cuda on
    the trained flagship experiment: predict_ab --set CC_FILTER=3d (the 3D
    kernel and K1 once per patient-phase), tta_ab --mode coords and
    int8_ab --calib-studies 4 (K1 and K2 once per patient-phase), and
    soup_ab on a 4-member CV root of the fold and its noisy copies, each
    member's test split predicted first (K1 and K2 once per patient-phase
    of each). Each path's launches exact; each printed mean equal to the
    mean read back from the two df_eval.csv files the tool names."""
    phases = 2 * len(test_patients)
    base = ["-exp", exp, "-data", data_root]
    cuda = ["--device", DEV]
    by_path = {}
    runs = (("ab:predict_ab_cc3d", predict_ab.main,
             base + ["--set", "CC_FILTER=3d", "--suffix", "cc3d"],
             {"k1": phases, "k2": 0, "cc3d": phases}),
            ("ab:tta_ab_coords", tta_ab.main, base + ["--mode", "coords"],
             {"k1": phases, "k2": phases, "cc3d": 0}),
            ("ab:int8_ab", int8_ab.main, base + ["--calib-studies", "4"],
             {"k1": phases, "k2": phases, "cc3d": 0}))
    figures = {}
    for tag, main_fn, argv, want in runs:
        _, counts, wall_s, printed = _run_tool(main_fn, argv + cuda)
        check(counts == want, f"{tag}: launches {counts}, want {want}")
        means, worst = _hold_ab(tag, printed, phases)
        by_path[tag] = counts
        figures[tag] = {"wall_s": wall_s, "means": means,
                        "worst_mean_gap": worst}
    root = _ensemble_root(fold, os.path.join(work, "ab"))
    _reset_all()
    for k in range(ENSEMBLE_MEMBERS):
        pred_fold(_fold_config(os.path.join(root, f"f{k}")), device=DEV)
    members = 4 * ENSEMBLE_MEMBERS  # each fold tests 2 patients x ED/ES
    by_path["ab:members_pred_fold"] = _counts()
    want = {"k1": members, "k2": members, "cc3d": 0}
    check(by_path["ab:members_pred_fold"] == want,
          f"ab members: launches {by_path['ab:members_pred_fold']}")
    _, counts, wall_s, printed = _run_tool(soup_ab.main,
                                           ["-exp", root, "-data", data_root]
                                           + cuda)
    check(counts == want, f"ab:soup_ab: launches {counts}, want {want}")
    means, worst = _hold_ab("ab:soup_ab", printed, members)
    by_path["ab:soup_ab"] = counts
    figures["ab:soup_ab"] = {"wall_s": wall_s, "means": means,
                             "worst_mean_gap": worst}
    log("ab-tools", mean_atol=AB_MEAN_ATOL, launches=by_path, **figures)
    return by_path


def _check_summary(df_eval, summary_csv):
    """analyze_results' summary.csv against numpy on df_eval.csv's cells:
    every poster metric present, its mean, sample SD (ddof 1) and n."""
    with open(df_eval, newline="") as fh:
        rows = list(csv.DictReader(fh))
    with open(summary_csv, newline="") as fh:
        got = {r["metric"]: r for r in csv.DictReader(fh)}
    want = 0
    for label, col in analyze_results.METRIC_MAP:
        vals = []
        for r in rows:
            try:
                v = float(r.get(col, ""))
            except ValueError:
                continue
            if not np.isnan(v):
                vals.append(v)
        if not vals:
            continue
        want += 1
        r = got.get(label)
        check(r is not None and int(r["n"]) == len(vals),
              f"summary: {label} row {r}, n {len(vals)}")
        for key, ref in (("mean", np.mean(vals)),
                         ("sd", np.std(vals, ddof=1) if len(vals) > 1
                          else float("nan"))):
            value = float(r[key]) if r[key] else float("nan")
            check((np.isnan(ref) and np.isnan(value))
                  or abs(value - ref) <= SUMMARY_RTOL * max(abs(ref), 1e-300),
                  f"summary: {label} {key} {value}, numpy {ref}")
    check(want > 0 and len(got) == want,
          f"summary: {len(got)} rows, want {want}")
    return want


def phase_quickstart(work):
    """quickstart: the port's synthetic quickstart on the card (--epochs 3
    --patients 4 --tta --int8; 64², depth 3, 16 filters, BatchNorm, batch
    32, its defaults otherwise), then analyze_results on its df_eval.csv.
    K1 once per train and eval step, sample batch and patient-phase of the
    three pred_folds (plain, TTA, int8), K2 once per patient-phase of
    each; the plain, TTA and int8 df_eval.csv one row per patient-phase;
    summary.csv equal to numpy's statistics of the csv."""
    root = os.path.join(work, "quickstart")
    epochs = 3
    out, counts, wall_s, _ = _run_tool(synthetic_quickstart.main, [
        "--root", root, "--epochs", str(epochs), "--patients", "4",
        "--tta", "--int8", "--device", DEV])
    with open(os.path.join(root, "df_kfold.csv"), newline="") as fh:
        fold0 = [r for r in csv.DictReader(fh) if r["fold"] == "0"]
    n_train = sum(r["modality"] == "train" for r in fold0)
    n_test = sum(r["modality"] == "test" for r in fold0)
    test = {r["patient"] for r in fold0 if r["modality"] == "test"}
    cfg = synthetic_quickstart.quickstart_config(root, epochs, 64)
    batch = cfg["BATCHSIZE"]
    phases = 2 * len(test)
    k1 = epochs * (n_train // batch + -(-n_test // batch)) \
        + _sample_launches(cfg, n_train, n_test) + 3 * phases
    want = {"k1": k1, "k2": 3 * phases, "cc3d": 0}
    check(counts == want, f"quickstart: launches {counts}, want {want}")
    for path in (out["df_eval"], out["tta"]["df_eval"]["tta"],
                 out["int8"]["df_eval"]["int8"]):
        with open(path, newline="") as fh:
            n = sum(1 for _ in csv.DictReader(fh))
        check(n == phases, f"quickstart: {path} has {n} rows")
    t0 = time.perf_counter()
    analysis, _, _, _ = _run_tool(analyze_results.main,
                                  ["--df", out["df_eval"]])
    analyze_s = time.perf_counter() - t0
    summary = os.path.join(os.path.dirname(out["df_eval"]), "figures",
                           "summary.csv")
    metrics = _check_summary(out["df_eval"], summary)
    log("quickstart", wall_s=wall_s, analyze_s=analyze_s, launches=counts,
        train_slices=n_train, test_slices=n_test, patient_phases=phases,
        means=out["means"], sd=out["sd"],
        tta_means=out["tta"]["means"], int8_means=out["int8"]["means"],
        summary_metrics=metrics, figures=analysis["figures"])
    return {"quickstart": counts}


# the paths that run CC_FILTER '3d' and so launch the 3D CC kernel
CC3D_PATHS = ("predict_cli_3d", "serve_3d", "predict_4d_3d", "override_twin",
              "ab:predict_ab_cc3d")


def _ms(us):
    return None if us is None else us / 1e3


def main():
    check(not _loaded_foreign(), f"importing the port loaded "
          f"{_loaded_foreign()}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 1

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log("device", name=kind, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)

    phase_build()
    k2, k2_err = phase_k2()
    k1, k1_err = phase_k1()
    k1_3d, k1_3d_err = phase_k1(k1_3d_cases(), phase="k1-3d")
    cc3d, cc3d_err = phase_cc3d()
    # from here on the 3D kernel counts the launches of the paths
    kernels.converge_labels_3d_cuda.launches = 0

    with open(FLAGSHIP, encoding="utf-8") as fh:
        cfg = json.load(fh)
    model = phase_forward(cfg)
    check(kernels.converge_labels_3d_cuda.launches == 0,
          "forward: the 3D CC kernel launched")
    by_path = {"serve": phase_serve(cfg, model)}
    train_paths, flagship_timing, cine_cc = phase_train(cfg)
    by_path.update(train_paths)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_quick_") as work:
        by_path.update(phase_quickstart(work))
    kernels.converge_labels_3d_cuda.launches = 0
    phase_train_f32(cfg)
    with open(os.path.join(TEMPLATES, "example_config.json"),
              encoding="utf-8") as fh:
        # with ELU: at a random init the float32 gradient of this ReLU
        # BatchNorm net lies 5.5% (CPU) to 16% (card) of max |g| from
        # float64 (PERF.md), so no bound could tell a fault there
        phase_train_f32(dict(json.load(fh), ACTIVATION="elu"),
                        phase="train-f32-bn", grad_atol=BN_GRAD_ATOL)
    phase_histmatch()
    phase_forward(dict(cfg, USE_UPSAMPLE=False), phase="forward-transpose",
                  bf16_max=BF16_T_MAX_ATOL, bf16_mean=BF16_T_MEAN_ATOL)
    by_path.update(phase_variants(flagship_timing))
    by_path.update(phase_trainer_features(cfg, flagship_timing, smi))
    phase_optimizers(cfg)
    with open(CINE, encoding="utf-8") as fh:
        cine = json.load(fh)
    phase_forward_3d(cine, "forward-3d", BF16_3D_MAX_ATOL, BF16_3D_MEAN_ATOL)
    phase_forward_3d(dict(cine, USE_UPSAMPLE=False), "forward-3d-transpose",
                     BF16_3D_T_MAX_ATOL, BF16_3D_T_MEAN_ATOL,
                     unheld=("no_norm_ConvBlock_1",))
    for name in HYBRID_BF16:
        phase_forward_hybrid(cine, name)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cine_") as work:
        train, val, cohort = _cine_cohort(work)
        by_path.update(phase_train_3d(train, val, cohort, work))
        by_path.update(phase_train_hybrid(cine, train, val, work))
        by_path.update(phase_skip_list(cine, train))
    # every path but those with CC_FILTER '3d' (counted by their own
    # entries) ran without the 3D kernel
    check(kernels.converge_labels_3d_cuda.launches == 0,
          "the 3D CC kernel launched on a path without CC_FILTER '3d'")
    launched = sorted(p for p, n in by_path.items() if n.get("cc3d"))
    check(launched == sorted(CC3D_PATHS),
          f"the 3D CC kernel launched on {launched}, want {CC3D_PATHS}")

    h2, h1, p1 = k2["random-0.55"], k1["main-s2"], k1["pred-s2"]
    stacked, c1 = k2["landmark-like"], k1_3d["cine-s2"]
    h3, dense3 = cc3d["landmark-like"], cc3d["random-0.55"]
    k2_cine, cc3d_cine = cine_cc["k2"], cine_cc["cc3d"]

    def launches(kernel):
        # a path without an entry for the 3D kernel was checked to launch
        # it no time
        return {"launches": sum(n.get(kernel, 0) for n in by_path.values()),
                "launches_by_path": {path: n.get(kernel, 0)
                                     for path, n in by_path.items()}}
    print(json.dumps({"kernels": [
        {"name": "converge_labels_cuda", "route": "cuda",
         "source": "cmrtpu_torch/csrc/cc_labels.cu",
         "replaces": "cmrtpu/ops/pallas_kernels.py:148",
         **launches("k2"), "max_abs_err": k2_err,
         "case": f"random-0.55 {h2['shape']}",
         "ms": h2["ms"], "graph_ms": h2["graph_ms"],
         "device_ms": _ms(h2["device_us"]),
         "plain_ms": h2["plain_ms"], "bound_ms": h2["bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "stacked_case": f"landmark-like {stacked['shape']}",
         "stacked_ms": stacked["ms"], "stacked_graph_ms": stacked["graph_ms"],
         "stacked_device_ms": _ms(stacked["device_us"]),
         "stacked_bound_ms": stacked["bound_ms"],
         "cine_case": f"predict-4d's stacked labels {k2_cine['shape']}",
         "cine_ms": k2_cine["ms"], "cine_graph_ms": k2_cine["graph_ms"],
         "cine_device_ms": _ms(k2_cine["device_us"]),
         "cine_plain_ms": k2_cine["plain_ms"],
         "cine_bound_ms": k2_cine["bound_ms"]},
        {"name": "gaussian_blur_2d_cuda", "route": "cuda",
         "source": "cmrtpu_torch/csrc/gaussian_blur.cu",
         "replaces": "cmrtpu/ops/pallas_kernels.py:87",
         **launches("k1"), "max_abs_err": max(k1_err, k1_3d_err),
         "case": f"main-s2 {h1['shape']} sigma 2, L2 warm",
         "ms": h1["ms"], "graph_ms": h1["graph_ms"],
         "cold_graph_ms": h1["cold_graph_ms"],
         "plain_ms": h1["plain_ms"], "bound_ms": h1["bound_us"] / 1e3,
         "bound_by": h1["bound_by"], "library_ms": h1["library_ms"],
         "pred_case": f"pred-s2 {p1['shape']} sigma 2, L2 warm",
         "pred_ms": p1["ms"], "pred_graph_ms": p1["graph_ms"],
         "pred_plain_ms": p1["plain_ms"],
         "pred_bound_ms": p1["bound_us"] / 1e3,
         "pred_library_ms": p1["library_ms"],
         "cine_case": f"cine-s2 {c1['shape']} sigma 2, L2 warm",
         "cine_ms": c1["ms"], "cine_graph_ms": c1["graph_ms"],
         "cine_cold_graph_ms": c1["cold_graph_ms"],
         "cine_plain_ms": c1["plain_ms"],
         "cine_bound_ms": c1["bound_us"] / 1e3,
         "cine_library_ms": c1["library_ms"]},
        {"name": "converge_labels_3d_cuda", "route": "cuda",
         "source": "cmrtpu_torch/csrc/cc_labels_3d.cu",
         "replaces": "cmrtpu/ops/connected_components.py:133 (an XLA "
                     "while_loop, not Pallas)",
         **launches("cc3d"), "max_abs_err": cc3d_err,
         "case": f"landmark-like {h3['shape']}",
         "ms": h3["ms"], "graph_ms": h3["graph_ms"],
         "device_ms": _ms(h3["device_us"]),
         "plain_ms": h3["plain_ms"], "bound_ms": h3["bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "dense_case": f"random-0.55 {dense3['shape']}",
         "dense_ms": dense3["ms"], "dense_graph_ms": dense3["graph_ms"],
         "dense_device_ms": _ms(dense3["device_us"]),
         "dense_plain_ms": dense3["plain_ms"],
         "dense_bound_ms": dense3["bound_ms"],
         "cine_case": f"predict-4d-3d's stacked labels {cc3d_cine['shape']}",
         "cine_ms": cc3d_cine["ms"], "cine_graph_ms": cc3d_cine["graph_ms"],
         "cine_device_ms": _ms(cc3d_cine["device_us"]),
         "cine_plain_ms": cc3d_cine["plain_ms"],
         "cine_bound_ms": cc3d_cine["bound_ms"]}]}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(cards_main(int(sys.argv[2])) if sys.argv[1:2] == ["--cards"]
             else main())
