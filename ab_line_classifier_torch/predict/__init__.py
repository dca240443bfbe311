"""Inference: the Predictor, clip aggregation, the CLI and the serving
benchmark of the PyTorch port."""
