"""Evaluation of the port: Melception fidelity metrics (FID / ISc / KID / KL)
over folders of mels, and the caption metrics of the ACT captioner."""

from .metrics import calculate_fid, calculate_isc, calculate_kid, calculate_kl  # noqa: F401
