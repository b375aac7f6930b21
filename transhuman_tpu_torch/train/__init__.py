"""Training: losses, the warmup-cosine schedule, optimizers, the train step
and checkpoints (counterpart of transhuman_tpu/train)."""
