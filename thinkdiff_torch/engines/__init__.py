"""engines of the PyTorch port (see thinkdiff_torch/__init__.py)."""
