"""Acceleration structures of the PyTorch port."""
