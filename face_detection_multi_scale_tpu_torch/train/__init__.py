"""Single-card training: targets, the loss, the trainer, checkpoints,
autoanchor, hyperparameter presets and evolution."""
