"""cmrtpu_torch — the serving and training paths of ``cmrtpu`` in PyTorch,
with its kernels written by hand in CUDA C++ for NVIDIA Hopper (sm_90a).

``cmrtpu`` (JAX/Flax/Pallas) stays the reference: every module here mirrors
the ``cmrtpu`` module of the same name and is held against it on identical
inputs by ``tests/test_torch_*.py``. This package imports ``torch`` and never
``cmrtpu``, ``jax``, ``flax``, ``optax``, ``orbax`` or ``pandas``. It keeps
its own copies of the numpy-only host modules it needs (``config``, ``io``,
``native``, ``ops.resample``, ``pipeline.transforms``,
``predict.postprocess``, ``utils.io_utils``, ``utils.tfevents``), so file
formats, geometry and config keys are those of ``cmrtpu``.

Layer map, entry points first:
  cli/serve.py                 directory serving CLI (-exp <fold_dir>)
  predict/serving.py           ServingEngine, process_study, serve_directory
  predict/predictor.py         Predictor, preprocessing, thresholding, CC_FILTER
  cli/train.py                 training CLI (-cfg <json> -data <root>)
  train/fold.py                run_experiment, train_fold
  train/trainer.py             Trainer: epoch/callback loop, fit_cached, fit_streamed
  train/callbacks.py           checkpoint, LR plateau, early stop, TB, CSV
  train/device_cache.py        dataset on the card (replicated or sharded, one
                               shard); the fused gather-augment-target-step
  train/streaming.py           StreamedLoop: packed host batches, STREAM_ECHO
  train/manual_collectives.py  GRAD_ALLREDUCE_DTYPE: gradients cast and back
  parallel/prefetch.py         numpy_prefetch thread; PutAhead pinned copies
  train/steps.py               TrainState: train_step / eval_step
  train/losses.py, optimizers.py, eval/detection.py   loss, Adam, loc_mm
  pipeline/generator.py        host stage and batch API (DataGenerator), finalize_batch
  pipeline/augment.py          draw_params / apply_params on the card
  pipeline/histmatch.py        Var.1 histogram matching (binned, exact), quota gate
  data/dataset.py              slice names, fold lists
  models/hybrids.py            get_model; the 2D-in-3D hybrids
  models/unet.py               2D/3D U-Net, (2+1)D blocks, deep supervision
  models/layers.py             resizes, affine helpers, UnetWrapper
  train/checkpoint.py          model.npz in the cmrtpu key layout (weights bridge)
  ops/gaussian.py              heatmap targets; plain torch blur
  ops/connected_components.py  largest-component filter; plain torch labels
  ops/cuda_kernels.py          nvcc build, ctypes binding, launch counters
  csrc/gaussian_blur.cu        K1, separable Gaussian blur (sm_90a)
  csrc/cc_labels.cu            K2, connected-component labels (sm_90a)
  tools/                       the A/B tools, the quickstart, analyze_results,
                               the demos
  utils/profiling.py           StageTimer, GLOBAL_TIMER, span, trace
  visualization/               figures (matplotlib imported where drawn)
  config.py, io/, native/, ops/resample.py, pipeline/transforms.py,
  predict/postprocess.py, utils/   copies of cmrtpu's host modules
"""

__version__ = "0.2.0"
