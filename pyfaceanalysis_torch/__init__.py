"""pyfaceanalysis_torch: the PyTorch/CUDA port of pyfaceanalysis_tpu.

Face detection with cascades of hierarchical SFA networks and Gaussian
soft-regressors, run on an NVIDIA GPU (Hopper, ``sm_90a``). The JAX package
``pyfaceanalysis_tpu`` is the reference: this package mirrors its module
names and functions, imports nothing from it and never imports JAX.

Ported so far: the serving path of ``engine.detector.FaceDetector`` --
``detect(image)`` with the age/race/gender heads, ``detect_batch(images)``
(one fused cascade over the windows of all images, or one cascade per
image) and ``detect_stream(batches)`` -- with the JAX package's two Pallas
TPU kernels as hand-written CUDA kernels (``ops/csrc/crop.cu``,
``ops/csrc/gather.cu``). Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from pyfaceanalysis_torch.config import DetectorConfig, resolve_device  # noqa: F401
