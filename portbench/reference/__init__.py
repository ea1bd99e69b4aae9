"""The plain reference the benchmark holds the port to: a single-image
face detector in plain PyTorch and NumPy (``detect``), its model loader
(``model``) and the comparison that decides ``correct`` (``compare``).
It imports nothing of the program it judges."""
