"""Training: the augmentation-to-update step, the two-phase fit with Keras
callbacks, and the ``single_train`` experiment and its CLI."""
