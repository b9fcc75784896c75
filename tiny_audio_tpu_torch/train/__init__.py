"""Training on PyTorch: optimizer, collator, data, augmentation, config
composition, the Trainer (``python -m tiny_audio_tpu_torch.train``) and the
offline convergence ladder (:mod:`.convergence`)."""
