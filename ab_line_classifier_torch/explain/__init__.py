"""Explainability of the PyTorch port: Grad-CAM and its CLI."""
