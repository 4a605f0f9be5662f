"""cmrtpu_torch — the serving path of ``cmrtpu`` in PyTorch, with its kernel
written by hand in CUDA C++ for NVIDIA Hopper (sm_90a).

``cmrtpu`` (JAX/Flax/Pallas) stays the reference: every module here mirrors
the ``cmrtpu`` module of the same name and is held against it on identical
inputs by ``tests/test_torch_*.py``. This package imports ``torch`` and never
``jax``, ``flax``, ``optax``, ``orbax`` or ``pandas``. It shares the
numpy-only host modules of ``cmrtpu`` (``config``, ``io``, ``native``,
``ops.resample``, ``pipeline.transforms``, ``predict.postprocess``,
``utils.io_utils``), so file formats, geometry and config keys are identical
by construction.

Layer map (the serving main path, entry point first):
  cli/serve.py                 directory serving CLI (-exp <fold_dir>)
  predict/serving.py           ServingEngine, process_study, serve_directory
  predict/predictor.py         Predictor, preprocessing, thresholding, CC_FILTER
  models/hybrids.py            get_model (MODEL_VARIANT 'unet')
  models/unet.py               2D U-Net nn.Modules (NHWC in, NHWC out)
  train/checkpoint.py          model.npz in the cmrtpu key layout (weights bridge)
  io.py                        NIfTI/NRRD I/O (re-exports the shared cmrtpu.io)
  ops/connected_components.py  largest-component filter; plain torch labels
  ops/cuda_kernels.py          nvcc build, ctypes binding, launch counter
  csrc/cc_labels.cu            connected-component label kernel (sm_90a)
"""

__version__ = "0.1.0"
