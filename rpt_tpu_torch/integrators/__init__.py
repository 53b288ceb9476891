"""Integrators of the PyTorch port."""
