"""Command-line entry points of the port beside ``thinkdiff_torch.train``."""
