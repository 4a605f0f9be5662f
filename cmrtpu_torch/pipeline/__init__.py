"""Host stage, augmentation and targets (counterparts of ``cmrtpu.pipeline``)."""
