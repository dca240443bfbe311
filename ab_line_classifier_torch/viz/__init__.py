"""Figures of the PyTorch port."""
