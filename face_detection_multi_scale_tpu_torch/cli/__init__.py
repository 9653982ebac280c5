"""Command-line entry points of the port: `python -m
face_detection_multi_scale_tpu_torch.cli.<name>` (test_widerface,
evaluate_widerface, test, batch_predict, download_widerface, ...). Each
one that runs a model takes `--device` (default `cuda`; `cpu` to run
without a card)."""
