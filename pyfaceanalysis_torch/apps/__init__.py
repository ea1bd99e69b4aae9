"""Command-line tools; run as ``python -m pyfaceanalysis_torch.apps.<name>``."""
