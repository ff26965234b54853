"""Fréchet Inception Distance: a copy of `stinet_tpu/metrics/fid.py`
(numpy and scipy; the reference's cumulative, session-keyed FID tracker,
fid_score_cumulative.py:43-188). Activations stream into per-session
buffers as float64 numpy, one host copy a batch; statistics and the
Fréchet distance (sqrtm with the eps-on-the-diagonal retry) are computed on
demand. The feature extractor is pluggable: the port's InceptionV3 pool3
features (models/inception.py), whose output `add_images` brings to the
host."""
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch
from scipy import linalg


def _sqrtm(a):
    """linalg.sqrtm with scipy's LinAlgWarning suppressed: singular products
    (rank-deficient covariances from small sample counts) are EXPECTED here
    and handled by the eps-on-the-diagonal retry below — the warning would
    otherwise leak to every caller streaming few activations."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", linalg.LinAlgWarning)
        out = linalg.sqrtm(a)
    return out[0] if isinstance(out, tuple) else out  # scipy<1.17 (sqrtm, errest)


def calculate_activation_statistics(activations: np.ndarray):
    mu = np.mean(activations, axis=0)
    sigma = np.cov(activations, rowvar=False)
    return mu, sigma


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
    """||mu1 - mu2||^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)), with the reference's
    eps-on-the-diagonal retry for numerically singular products
    (fid_score_cumulative.py:134-188)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    covmean = _sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                f"Imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return (diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
            - 2 * np.trace(covmean))


class FIDScoreCumulative:
    """Streaming activation sessions: `add_activations(key, acts)` per batch,
    `get_statistics(key)` / `fid_between(key1, key2)` on demand."""

    def __init__(self, feature_fn: Optional[Callable] = None):
        self.feature_fn = feature_fn
        self._buffers: Dict[str, list] = {}
        self._stats: Dict[str, tuple] = {}

    def reset(self, key: str):
        self._buffers.pop(key, None)
        self._stats.pop(key, None)

    def add_activations(self, key: str, activations: np.ndarray):
        self._buffers.setdefault(key, []).append(np.asarray(activations))
        self._stats.pop(key, None)

    def add_images(self, key: str, images):
        """Add the activations of `images`: `feature_fn`'s output (a
        tensor on any device, or an array) comes to the host in one copy,
        as float64."""
        assert self.feature_fn is not None, "no feature extractor configured"
        acts = self.feature_fn(images)
        if isinstance(acts, torch.Tensor):
            acts = acts.detach().to("cpu", torch.float64).numpy()
        self.add_activations(key, np.asarray(acts, np.float64))

    def num_samples(self, key: str) -> int:
        return sum(len(a) for a in self._buffers.get(key, []))

    def get_statistics(self, key: str):
        if key not in self._stats:
            acts = np.concatenate(self._buffers[key], axis=0)
            self._stats[key] = calculate_activation_statistics(acts)
        return self._stats[key]

    def freeze_statistics(self, key: str):
        """Compute + keep stats, drop the buffers (used for the val-GT
        session computed once at init, reference
        inpainting2d_trainer.py:153-156)."""
        stats = self.get_statistics(key)
        self._buffers.pop(key, None)
        self._stats[key] = stats
        return stats

    def fid_between(self, key1: str, key2: str) -> float:
        mu1, s1 = self.get_statistics(key1)
        mu2, s2 = self.get_statistics(key2)
        return float(calculate_frechet_distance(mu1, s1, mu2, s2))
