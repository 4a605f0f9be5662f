"""Head-to-head quality A/B: cmrtpu_torch against a tf_keras twin of the
reference graph — counterpart of cmrtpu's ``tools/tf_twin_ab.py``.

    python -m cmrtpu_torch.tools.tf_twin_ab [--root /tmp/tf_twin_ab]
        [--patients 24] [--dim 64] [--epochs 300]

Both frameworks train on identical model-ready tensors: the full_cv_demo
phantom cohort, sliced by ``cli.make_dataset``, through the deterministic
DataGenerator (resample, clip, normalise, pad/crop, sigma-2 heatmap
targets; augmentation off on both sides). The twin is a Keras-2 rebuild of
the reference's U-Net (ref: src/models/Unets.py:61-133), trained with the
reference's loss (BceDiceLoss) and optimizer (adam); both are scored by the
same centre-of-mass landmark extraction in mm.

CPU by design, as cmrtpu's: both sides train on the host (the card's host
has no tensorflow), which is imported only inside ``main``.
Prints one JSON summary line: {"config", "torch_mm", "tf_mm", "delta_mm"}.
"""

import argparse
import json
import os

import numpy as np

from cmrtpu_torch import config as C


def materialize(xs, ys, cfg):
    """Model-ready (x, y) arrays via the DataGenerator (deterministic:
    SHUFFLE, AUGMENT and HIST_MATCHING off)."""
    from cmrtpu_torch.pipeline.generator import DataGenerator

    gen = DataGenerator(xs, ys, config=dict(cfg, SHUFFLE=False,
                                            AUGMENT=False,
                                            HIST_MATCHING=False),
                        device="cpu")
    bx, by = [], []
    for i in range(len(gen)):
        x, y = gen[i]
        bx.append(x.cpu().numpy())
        by.append(y.cpu().numpy())
    return np.concatenate(bx), np.concatenate(by)


def com_mm_errors(pred, gt, spacing_mm):
    """Per-slice, per-channel CoM distance in mm where both detect (the
    evaluation's both-present pairing), and the detection counts."""
    import torch

    from cmrtpu_torch.eval.detection import peaks_com

    p_xy, p_ok = (a.numpy() for a in peaks_com(torch.from_numpy(pred)))
    g_xy, g_ok = (a.numpy() for a in peaks_com(torch.from_numpy(gt)))
    both = p_ok & g_ok
    dists = np.linalg.norm(np.nan_to_num(p_xy) - np.nan_to_num(g_xy),
                           axis=-1) * spacing_mm
    out = {}
    for ch, name in enumerate(("ant", "inf")):
        m = both[:, ch]
        out[name] = float(dists[:, ch][m].mean()) if m.any() else float("nan")
        out[f"det_{name}"] = float(p_ok[:, ch].sum())
    return out


def _linspace_dropouts(cfg):
    lin = np.linspace(C.get(cfg, "DROPOUT_MIN"), C.get(cfg, "DROPOUT_MAX"),
                      C.get(cfg, "DEPTH"))
    return [round(v, 1) for v in lin]


def _tf_conv_block(keras, x, filters, cfg):
    """conv [+BN] with the reference's ordering switch (ref: conv_layer_fn,
    src/models/KerasLayers.py:660-693)."""
    ndims = len(C.get(cfg, "DIM"))
    conv = getattr(keras.layers, f"Conv{ndims}D")
    f_size = tuple(C.get(cfg, "F_SIZE"))[-ndims:]
    act = C.get(cfg, "ACTIVATION")
    bn = C.get(cfg, "BATCH_NORMALISATION")
    if C.get(cfg, "BN_FIRST"):
        x = conv(filters, f_size, padding=C.get(cfg, "PAD"),
                 kernel_initializer=C.get(cfg, "KERNEL_INIT"))(x)
        if bn:
            x = keras.layers.BatchNormalization(axis=-1)(x)
        x = keras.layers.Activation(act)(x)
    else:
        x = conv(filters, f_size, activation=act, padding=C.get(cfg, "PAD"),
                 kernel_initializer=C.get(cfg, "KERNEL_INIT"))(x)
        if bn:
            x = keras.layers.BatchNormalization(axis=-1)(x)
    return x


def build_tf_twin(keras, config):
    """The reference U-Net graph in tf_keras (ref: unet, Unets.py:755-833,
    and create_unet's head, Unets.py:128): cmrtpu's
    ``tests/test_tf_parity.py:build_tf_twin``."""
    cfg = C.normalise_config(config)
    ndims = len(C.get(cfg, "DIM"))
    m_pool = tuple(C.get(cfg, "M_POOL"))[-ndims:]
    f_size = tuple(C.get(cfg, "F_SIZE"))[-ndims:]
    depth = C.get(cfg, "DEPTH")
    act = C.get(cfg, "ACTIVATION")
    pool = getattr(keras.layers, f"MaxPooling{ndims}D")
    conv = getattr(keras.layers, f"Conv{ndims}D")
    dropouts = _linspace_dropouts(cfg)

    inputs = keras.layers.Input(
        (*C.get(cfg, "DIM"), C.get(cfg, "IMG_CHANNELS")))
    x = inputs
    filters = C.get(cfg, "FILTERS")
    skips = []
    for level in range(depth):
        x = _tf_conv_block(keras, x, filters, cfg)
        x = keras.layers.Dropout(dropouts[level])(x)
        skip = _tf_conv_block(keras, x, filters, cfg)
        skips.append(skip)
        x = pool(m_pool)(skip)
        filters *= 2
    x = _tf_conv_block(keras, x, filters, cfg)
    x = keras.layers.Dropout(C.get(cfg, "DROPOUT_MAX"))(x)
    x = _tf_conv_block(keras, x, filters, cfg)
    up_drops = list(dropouts)
    for _ in range(depth):
        filters //= 2
        if C.get(cfg, "USE_UPSAMPLE"):
            up = getattr(keras.layers, f"UpSampling{ndims}D")
            x = up(size=m_pool)(x)
            x = conv(filters, f_size, activation=act,
                     padding=C.get(cfg, "PAD"),
                     kernel_initializer=C.get(cfg, "KERNEL_INIT"))(x)
        else:
            conv_t = getattr(keras.layers, f"Conv{ndims}DTranspose")
            x = conv_t(filters, f_size, strides=m_pool, activation=act,
                       padding=C.get(cfg, "PAD"),
                       kernel_initializer=C.get(cfg, "KERNEL_INIT"))(x)
        x = keras.layers.Concatenate(axis=-1)([x, skips.pop()])
        x = _tf_conv_block(keras, x, filters, cfg)
        x = keras.layers.Dropout(up_drops.pop())(x)
        x = _tf_conv_block(keras, x, filters, cfg)
    outputs = conv(C.get(cfg, "MASK_CLASSES"), (1,) * ndims,
                   activation="sigmoid", name="unet")(x)
    return keras.Model(inputs=[inputs], outputs=[outputs])


def tf_dice(tf, y_true, y_pred):
    """Soft dice, smooth 1, fully flattened (ref: Loss_and_metrics.py:165):
    cmrtpu's ``tests/test_tf_parity.py:_tf_dice``."""
    yt = tf.reshape(tf.cast(y_true, tf.float32), [-1])
    yp = tf.reshape(tf.cast(y_pred, tf.float32), [-1])
    inter = tf.reduce_sum(yt * yp)
    return (2.0 * inter + 1.0) / (tf.reduce_sum(yt) + tf.reduce_sum(yp)
                                  + 1.0)


class _Batches:
    """Shuffled full batches of (x, y) per epoch from ``rng``."""

    def __init__(self, x, y, batch, rng):
        self.x, self.y, self.batch, self.rng = x, y, batch, rng

    def __iter__(self):
        order = self.rng.permutation(len(self.x))
        for s in range(0, len(order) - self.batch + 1, self.batch):
            sel = order[s:s + self.batch]
            yield self.x[sel], self.y[sel]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="/tmp/tf_twin_ab")
    ap.add_argument("--patients", type=int, default=24)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from cmrtpu_torch.cli.make_dataset import main as make_dataset_main
    from cmrtpu_torch.data.dataset import get_trainings_files
    from cmrtpu_torch.tools.full_cv_demo import generate_cohort
    from cmrtpu_torch.train.trainer import Trainer

    if not os.path.isdir(os.path.join(args.root, "2D")):
        hw = max(64, int(args.dim * 200 / 224))
        generate_cohort(args.root, n_patients=args.patients, hw=hw)
        make_dataset_main(args.root, os.path.join(args.root, "original"))

    cfg = {"DIM": [args.dim, args.dim], "SPACING": [1.2, 1.2],
           "RESAMPLE": True, "DEPTH": 4, "FILTERS": 32, "M_POOL": [2, 2],
           "F_SIZE": [3, 3], "MASK_VALUES": [1, 2], "MASK_CLASSES": 2,
           "BATCHSIZE": args.batch, "LEARNING_RATE": 1e-3,
           "OPTIMIZER": "adam", "LOSS_FUNCTION": "BceDiceLoss",
           "GAUS": True, "SIGMA": 2, "SCALER": "MinMax",
           "MIXED_PRECISION": False, "USE_UPSAMPLE": False,
           "BATCH_NORMALISATION": True, "SEED": args.seed,
           "AUGMENT": False, "EPOCHS": args.epochs}

    xt, yt, xv, yv = get_trainings_files(
        os.path.join(args.root, "2D"), fold=0,
        path_to_folds_df=os.path.join(args.root, "df_kfold.csv"))
    print(f"fold 0: {len(xt)} train / {len(xv)} val slices", flush=True)
    x_train, y_train = materialize(xt, yt, cfg)
    x_val, y_val = materialize(xv, yv, cfg)
    print(f"tensors: train {x_train.shape}, val {x_val.shape}", flush=True)
    spacing = float(cfg["SPACING"][0])
    # binary ground truth for CoM scoring, thresholded at 0.5 as the
    # predict path does
    gt_val = (y_val >= 0.5).astype(np.float32)

    # --- the port ---------------------------------------------------------
    trainer = Trainer(cfg, device="cpu")
    trainer.fit(_Batches(x_train, y_train, args.batch,
                         np.random.default_rng(args.seed)),
                epochs=args.epochs)
    port_pred = (trainer.predict(x_val) >= 0.5).astype(np.float32)
    port = com_mm_errors(port_pred, gt_val, spacing)
    print("cmrtpu_torch:", json.dumps(port), flush=True)

    # --- the TF twin ------------------------------------------------------
    import tensorflow as tf
    import tf_keras as keras

    tf.random.set_seed(args.seed)
    tf_model = build_tf_twin(keras, cfg)

    def bce_dice(y_true, y_pred):
        return (tf.reduce_mean(keras.losses.binary_crossentropy(
            y_true, y_pred)) - tf_dice(tf, y_true, y_pred))

    tf_model.compile(optimizer=keras.optimizers.Adam(cfg["LEARNING_RATE"]),
                     loss=bce_dice)
    tf_model.fit(x_train, y_train, batch_size=args.batch,
                 epochs=args.epochs, shuffle=True, verbose=0)
    tf_pred = (np.asarray(tf_model.predict(x_val, batch_size=args.batch,
                                           verbose=0))
               >= 0.5).astype(np.float32)
    tfm = com_mm_errors(tf_pred, gt_val, spacing)
    print("tf:", json.dumps(tfm), flush=True)

    summary = {
        "config": {"patients": args.patients, "dim": args.dim,
                   "epochs": args.epochs, "fold": 0, "augment": False,
                   "targets": "gaus_sigma2"},
        "torch_mm": {k: port[k] for k in ("ant", "inf")},
        "tf_mm": {k: tfm[k] for k in ("ant", "inf")},
        "delta_mm": {k: round(port[k] - tfm[k], 4) for k in ("ant", "inf")},
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
