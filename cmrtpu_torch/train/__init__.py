"""PyTorch counterparts of ``cmrtpu.train``: train step, device-resident loop, callbacks, fold loop."""
