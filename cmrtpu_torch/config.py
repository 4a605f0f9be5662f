"""Flat UPPERCASE-key experiment config — the de-facto public API of the reference.

The port's own copy of ``cmrtpu/config.py``: same keys, defaults, aliases
and paths, so both packages read one config file identically.

Reproduces the key surface of the reference config system
(ref: exp/template_cfgs/example_config.json, src/utils/Utils_io.py:163-213,
config.get(...) sites catalogued in SURVEY.md §2.4) with the same defaults.

Quirk compatibility (SURVEY.md "known reference quirks"):
  * ``REDUCE_LR_ON_PLAEAU_PATIENCE`` [sic] and the corrected
    ``REDUCE_LR_ON_PLATEAU_PATIENCE`` are both accepted.
  * ``LOSS_FUNCTION`` accepts both 'BcdDiceLoss' [sic] and 'BceDiceLoss'.
"""

from __future__ import annotations

import datetime
import json
import os
from typing import Any, Dict

# ---------------------------------------------------------------------------
# Defaults: every (key, default) pair consumed anywhere in the reference.
# TPU-native keys added at the end are new but optional (safe defaults).
# ---------------------------------------------------------------------------
DEFAULTS: Dict[str, Any] = {
    # hardware / run (ref: example_config.json:2-7; GPU keys kept for config
    # compatibility but ignored — device selection is JAX/TPU-native)
    "GPU_IDS": "0,1",
    "GPUS": ["/gpu:0", "/gpu:1"],
    "SEED": 42,
    "GENERATOR_WORKER": 16,
    "QUEUE_SIZE": 12,
    "EPOCHS": 100,
    "BATCHSIZE": 32,
    # paths / CV (ref: src/models/train_model.py:31-51)
    "EXPERIMENT": "UNDEFINED",
    "EXPERIMENTS_ROOT": "exp/",
    "DATA_PATH_SAX": None,
    "DATA_PATH_ORIG": None,
    "DF_FOLDS": None,
    "FOLD": 0,
    "FOLDS": [0, 1, 2, 3],
    # geometry (ref: example_config.json:16-27; DIM is numpy-ordered (y,x) or (z,y,x))
    "DIM": [224, 224],
    "SPACING": [1.2, 1.2],
    "RESAMPLE": True,
    "IMG_INTERPOLATION": 2,  # 2 == linear (sitk enum parity)
    "MSK_INTERPOLATION": 1,  # 1 == nearest neighbour
    # model (ref: src/models/Unets.py:80-106)
    "DEPTH": 4,
    "FILTERS": 32,
    "M_POOL": [2, 2],
    "F_SIZE": [3, 3],
    "BN_FIRST": False,
    "BATCH_NORMALISATION": True,
    "PAD": "same",
    "KERNEL_INIT": "he_normal",
    "ACTIVATION": "relu",
    "USE_UPSAMPLE": True,
    "IMG_CHANNELS": 1,
    "MASK_VALUES": [1, 2],
    "MASK_CLASSES": 2,
    # optimisation (ref: src/models/ModelUtils.py:75-118, KerasCallbacks.py:54-111)
    "OPTIMIZER": "adam",
    "LEARNING_RATE": 1e-4,
    "EPSILON": 1e-8,
    "DECAY": 0.0,
    "REDUCE_LR_ON_PLATEAU_PATIENCE": 5,
    "DECAY_FACTOR": 0.7,
    "POLY_LR_DECAY": False,
    "MIN_LR": 1e-12,
    "EARLY_STOPPING_PATIENCE": 25,
    "MODEL_PATIENCE": 20,
    "MONITOR_FUNCTION": "loss",
    "MONITOR_MODE": "min",
    "SAVE_MODEL_FUNCTION": "loss",
    "SAVE_MODEL_MODE": "min",
    "LOSS_FUNCTION": "BceDiceLoss",
    # regularisation / augmentation (ref: src/data/Generators.py:77-94,240-260,
    # src/data/Preprocess.py:382-422)
    "DROPOUT_MIN": 0.3,
    "DROPOUT_MAX": 0.5,
    "AUGMENT": False,
    "AUGMENT_PROB": 0.8,
    "RANDOMROTATE": False,
    "SHIFTSCALEROTATE": False,
    "GRIDDISTORTION": False,
    "DOWNSCALE": False,
    "BORDER_MODE": 4,  # reflect101 (cv2 enum parity)
    "BORDER_VALUE": 0,
    "HIST_MATCHING": False,
    "SHUFFLE": True,
    "SCALER": "MinMax",
    "GAUS": False,
    "SIGMA": 1,
    "MASKING_IMAGE": False,
    "MASKING_VALUES": [1, 2, 3],
    # inference / artifacts (ref: src/models/predict_model.py:159,
    # src/utils/KerasCallbacks.py:20-110)
    "CC_FILTER": False,          # predict-time biggest-component filter:
                                 # truthy = per-slice 2D (reference parity),
                                 # '3d' = volume-level (removes the isolated
                                 # off-slice false positives per-slice CC
                                 # cannot) — predictor.cc_clean_fn
    "TTA": False,                # rot90-orbit test-time augmentation at
                                 # inference (cmrtpu/predict/tta.py)
    "TTA_MODE": "probs",         # 'probs' = average sigmoid maps over the
                                 # orbit (can blur sub-pixel-offset peaks —
                                 # measured to DEGRADE converged runs);
                                 # 'coords' = average landmark COORDINATES
                                 # (per-member CoM, inverse-rotated, mean) —
                                 # peak blur impossible by construction
    "EMA": False,                # exponential-moving-average shadow of the
                                 # params (True -> decay 0.999, or a float);
                                 # eval/checkpoints/predict use the shadow
    "SAVE_LEARNING_PROGRESS_AS_TF": False,
    "SAVE_LEARNING_PROGRESS_AS_PNG": False,
    "SAVE_LEARNING_PROGRESS_FREQUENCY": 2,
    # --- TPU-native extensions (new; absent keys keep reference behaviour) ---
    "MIXED_PRECISION": True,     # bfloat16 activations on the MXU, f32 params
    "MESH_SHAPE": None,          # None -> 1D data mesh over all local devices
    "PREFETCH_DEPTH": 2,         # device prefetch double-buffering depth
    "CACHE_IN_MEMORY": True,     # cache deterministic preprocessing in RAM
    "PRNG_IMPL": "rbg",          # dropout-mask PRNG; rbg is ~1.4x faster than
                                 # threefry on TPU for conv-U-Net train steps
    "REMAT": False,              # rematerialise U-Net blocks in backward:
                                 # True = all levels, int N = the N shallowest
                                 # (HBM-traffic vs FLOPs trade, see unet.py)
    "BN_BF16": False,            # keep BatchNorm's big-tensor math in bf16
                                 # (f32 statistics only); MIXED_PRECISION-only
                                 # opt-in — see unet.py BF16BatchNorm
    "MONITOR_LOCALISATION": False,  # add loc_mm/loc_det (the target metric,
                                    # mm + FN upper bound) to the live
                                    # train/eval metrics; monitor best-only
                                    # checkpoints on 'val_loc_mm'/'min'
                                    # (eval/detection.py localisation_metrics)
    "DETECTION_STRATEGY": "com",    # landmark peak extraction: 'com'
                                    # (reference parity) | 'argmax' (natural
                                    # for GAUS heatmap targets)
    "DEVICE_CACHE_LIMIT_GB": 8.0,  # max HBM for the device-resident dataset
                                   # cache; larger datasets stream from host
    "CACHE_DTYPE": "float32",    # device-cache image storage; 'bfloat16'
                                 # halves HBM footprint (masks auto-pack to
                                 # uint8 when exact) — see device_cache.py
    "CACHE_PER_HOST": None,      # sharded-cache loading: None = auto (on for
                                 # multi-controller runs) — each process
                                 # materializes only its own devices' example
                                 # rows (device_cache.py per-host upload)
}

# accepted alternate spellings -> canonical key (reference quirk compat)
_ALIASES = {
    "REDUCE_LR_ON_PLAEAU_PATIENCE": "REDUCE_LR_ON_PLATEAU_PATIENCE",
}

# valid keys that intentionally carry no DEFAULTS entry: derived per-run
# paths, auto-resolving knobs (absence != False), and structured configs
# whose only sensible default is "unset". parse_override_pairs accepts
# these; everything else unknown is a typo.
_SETTABLE_EXTRA = frozenset({
    "AGC", "AUGMENT_GRID", "CACHE_RESHUFFLE_EPOCHS", "CACHE_SHARDED",
    "COMPILATION_CACHE_DIR", "CONFIG_PATH", "EXP_PATH", "FOLD_PATH",
    "FACTORIZED_3D",
    "GRAD_ALLREDUCE_DTYPE", "GROUP_NORM", "WS_I_UNDERSTAND",
    "HEADS", "HEAD_BIAS_PRIOR", "HEAD_MASK_RULES",
    "HISTORY_PATH", "HIST_MATCHING_BINS", "HIST_MATCHING_PROB",
    "LOGIT_SOFTCAP",
    "MODEL_PATH", "MODEL_VARIANT", "MOMENTUM", "QUANT_INT8", "RESUME",
    "STREAM_DTYPE", "STREAM_ECHO", "TENSORBOARD_PATH",
    "WEIGHT_STANDARDISATION",
    "SWIN_PATCH", "SWIN_EMBED_DIM", "SWIN_DEPTHS", "SWIN_HEADS",
    "SWIN_WINDOW", "SWIN_MLP_RATIO", "DROP_PATH_RATE",
})

# MODEL_VARIANT 'swin_unet' (models/swin_unet.py): the keys of the
# Swin-Unet and their defaults, swin_tiny_patch4_window7_224's widths
# (arXiv:2105.05537) with Swin-T's drop-path rate, 0.2 (arXiv:2103.14030,
# section 4.1). They live outside DEFAULTS, whose keys are the reference's.
SWIN_DEFAULTS: Dict[str, Any] = {
    "SWIN_PATCH": 4,
    "SWIN_EMBED_DIM": 96,
    "SWIN_DEPTHS": [2, 2, 2, 2],
    "SWIN_HEADS": [3, 6, 12, 24],
    "SWIN_WINDOW": 7,
    "SWIN_MLP_RATIO": 4,
    "DROP_PATH_RATE": 0.2,
}


def normalise_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Uppercase-filter, alias-map and default-fill a raw config dict."""
    cfg = dict(DEFAULTS)
    for key, value in (config or {}).items():
        if not isinstance(key, str) or not key.isupper():
            continue
        cfg[_ALIASES.get(key, key)] = value
    return cfg


def parse_override_pairs(pairs) -> Dict[str, Any]:
    """Parse CLI ``KEY=VAL`` override pairs into typed config entries.

    Values are JSON-decoded when possible; Python-literal spellings of the
    JSON atoms (``True``/``False``/``None``, any case) are mapped to real
    booleans/None instead of surviving as TRUTHY strings — ``--set
    TTA=False`` must disable the knob, not enable it. Everything else stays
    a string. Keys are upper-cased (normalise_config drops non-uppercase
    keys, so a lowercase ``--set tta=true`` would otherwise silently no-op)
    and checked against the known key surface (DEFAULTS + aliases);
    unknown keys raise instead of producing a twin identical to the plain
    run."""
    out: Dict[str, Any] = {}
    for pair in pairs:
        key, sep, val = str(pair).partition("=")
        if not sep:
            raise ValueError(f"override '{pair}' is not KEY=VAL")
        key = key.strip().upper()
        if (key not in DEFAULTS and key not in _ALIASES
                and key not in _SETTABLE_EXTRA):
            raise ValueError(
                f"unknown config key '{key}' in override '{pair}' — known "
                f"keys live in cmrtpu_torch/config.py (DEFAULTS/_SETTABLE_EXTRA)")
        try:
            out[key] = json.loads(val)
        except (json.JSONDecodeError, ValueError):
            lowered = val.strip().lower()
            if lowered in ("true", "false"):
                out[key] = lowered == "true"
            elif lowered in ("none", "null"):
                out[key] = None
            else:
                out[key] = val
    return out


def get(config: Dict[str, Any], key: str, default: Any = None):
    """config.get with alias + defaults fallback (mirrors reference convention)."""
    for k in (key, _ALIASES.get(key, key)):
        if k in config:
            return config[k]
    return DEFAULTS.get(key, default)


def ndims(config: Dict[str, Any]) -> int:
    """Model dimensionality is selected by len(DIM) (ref: src/models/Unets.py:90)."""
    return len(get(config, "DIM"))


def swin_settings(config: Dict[str, Any]) -> Dict[str, Any]:
    """The Swin-Unet's keys (SWIN_DEFAULTS where unset) with the
    resolution and window of each stage, ``stages``: a list of (h, w,
    window) from the patch grid down. A stage whose shorter side is at
    most SWIN_WINDOW attends over a window of that side, unshifted, as
    the public code does. Raises ValueError where DIM is not 2D, does not
    divide into the stages' patches and windows, or a stage's width does
    not divide into its heads."""
    out = {k: config.get(k, v) for k, v in SWIN_DEFAULTS.items()}
    dim = [int(d) for d in get(config, "DIM")]
    depths = [int(d) for d in out["SWIN_DEPTHS"]]
    heads = [int(h) for h in out["SWIN_HEADS"]]
    patch, embed = int(out["SWIN_PATCH"]), int(out["SWIN_EMBED_DIM"])
    window = int(out["SWIN_WINDOW"])
    if len(dim) != 2:
        raise ValueError(f"DIM {dim}: the Swin-Unet is 2D")
    if len(heads) != len(depths):
        raise ValueError(f"SWIN_HEADS {heads} and SWIN_DEPTHS {depths} "
                         "differ in length")
    scale = patch * 2 ** (len(depths) - 1)
    if any(d % scale for d in dim):
        raise ValueError(f"DIM {dim} is not divisible by SWIN_PATCH x "
                         f"2^(stages - 1) = {scale}")
    stages = []
    for i, n_heads in enumerate(heads):
        h, w = (d // (patch * 2 ** i) for d in dim)
        m = min(h, w) if min(h, w) <= window else window
        if h % m or w % m:
            raise ValueError(f"stage {i} at {h}x{w} does not divide into "
                             f"windows of {m}")
        if (embed * 2 ** i) % n_heads:
            raise ValueError(f"stage {i}: width {embed * 2 ** i} does not "
                             f"divide into {n_heads} heads")
        stages.append((h, w, m))
    out["stages"] = stages
    return out


def load_config(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as fh:
        return normalise_config(json.load(fh))


def timestamped_exp_path(config: Dict[str, Any], timestamp: str | None = None) -> str:
    """exp/<EXPERIMENT>/<YYYY-MM-DD_HH_MM> (ref: src/models/train_model.py:166-175)."""
    ts = timestamp or datetime.datetime.now().strftime("%Y-%m-%d_%H_%M")
    return os.path.join(get(config, "EXPERIMENTS_ROOT"), get(config, "EXPERIMENT"), ts)


def set_experiment_paths(config: Dict[str, Any], exp_path: str | None = None,
                         fold: int | None = None) -> Dict[str, Any]:
    """Populate EXP_PATH/MODEL_PATH/TENSORBOARD_PATH/CONFIG_PATH/HISTORY_PATH.

    Fold sub-folders follow the reference convention exp/<EXP>/<ts>/f<k>/
    (ref: src/models/train_model.py:40-47).
    """
    cfg = dict(config)
    exp_path = exp_path or cfg.get("EXP_PATH") or timestamped_exp_path(cfg)
    cfg["EXP_PATH"] = exp_path
    root = exp_path if fold is None else os.path.join(exp_path, f"f{fold}")
    if fold is not None:
        cfg["FOLD"] = fold
        cfg["FOLD_PATH"] = root
    cfg["MODEL_PATH"] = os.path.join(root, "model")
    cfg["TENSORBOARD_PATH"] = os.path.join(root, "tensorboard_logs")
    cfg["CONFIG_PATH"] = os.path.join(root, "config")
    cfg["HISTORY_PATH"] = os.path.join(root, "history")
    return cfg


_JSON_TYPES = (bool, int, str, float, list, dict, type(None))


def init_config(config: Dict[str, Any], save: bool = True) -> Dict[str, Any]:
    """Keep UPPERCASE keys, create experiment dirs, persist config/config.json.

    Serialises callables by name, exactly like the reference
    (ref: src/utils/Utils_io.py:163-213), so a saved experiment can be
    re-instantiated for inference with the identical configuration.
    """
    from cmrtpu_torch.utils.io_utils import ensure_dir

    cfg = {k: v for k, v in config.items() if isinstance(k, str) and k.isupper()
           and k not in ("HTML", "K")}
    cfg = set_experiment_paths(normalise_config(cfg), exp_path=cfg.get("EXP_PATH"),
                               fold=cfg.get("FOLD") if "FOLD_PATH" in cfg or save else cfg.get("FOLD"))
    for key in ("EXP_PATH", "MODEL_PATH", "TENSORBOARD_PATH", "CONFIG_PATH"):
        ensure_dir(cfg[key])

    if save:
        writable = {}
        for key, value in cfg.items():
            if callable(value):
                value = getattr(value, "__name__", getattr(value, "name", "unknownfunction"))
            if isinstance(value, _JSON_TYPES):
                writable[key] = value
        with open(os.path.join(cfg["CONFIG_PATH"], "config.json"), "w") as fh:
            json.dump(writable, fh, indent=2)
    return cfg
