"""Image front end (pyramid, patch extraction, contrast), the Gaussian
regressor, and the CUDA kernels with their ctypes wrappers."""
