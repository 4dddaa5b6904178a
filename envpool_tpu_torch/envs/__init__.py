"""Env families of the PyTorch port."""
