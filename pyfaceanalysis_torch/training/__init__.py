"""Training subsystem: synthetic data generation and layer-wise HiGSFA
training, on the device.

Port of ``pyfaceanalysis_tpu.training``: a procedural face renderer
(``synth``), dataset builders matching the reference's label ranges
(``datasets``), the real-photo anchor pool (``real``), the layer-wise
GSFA/PCA trainer that writes the full 22-stage pipeline (``trainer``), the
disc-ladder and eye-gate calibration (``calibration``) and the multi-seed
disc selection (``selection``). Random draws come from
:class:`~pyfaceanalysis_torch.training.sampler.Sampler`.
"""
