"""Checkpoint-free underwater style transfer (PyTorch port's numpy copy of
``boosting_rcnn_tpu/data/style_transfer.py``), the loader's ``dgaug``
option for ``DGaugFasterRCNN``.

The reference stylises each train image toward its domain's water type
with a privately trained network; the JAX package replaces it by colour
statistics, and so does the port, in the same float64 arithmetic:
``reinhard_transfer`` matches the per-channel mean and standard deviation
in Ruderman's lab space, ``hist_match`` matches each channel's histogram
by rank, and ``stylize`` blends the transfer with the content by a
``Beta(alpha, alpha)`` draw from the caller's ``RandomState``.  Images are
float arrays in [0, 1], ``(H, W, 3)`` RGB.
"""
import numpy as np

__all__ = ["reinhard_transfer", "hist_match", "stylize"]

_RGB2LMS = np.array(
    [[0.3811, 0.5783, 0.0402],
     [0.1967, 0.7244, 0.0782],
     [0.0241, 0.1288, 0.8444]], np.float64)
_LMS2LAB_A = np.array(
    [[1 / np.sqrt(3), 0, 0],
     [0, 1 / np.sqrt(6), 0],
     [0, 0, 1 / np.sqrt(2)]], np.float64)
_LMS2LAB_B = np.array(
    [[1, 1, 1],
     [1, 1, -2],
     [1, -1, 0]], np.float64)


def _rgb_to_lab(img):
    lms = np.clip(img, 1e-6, None) @ _RGB2LMS.T
    return np.log10(lms) @ (_LMS2LAB_A @ _LMS2LAB_B).T


def _lab_to_rgb(lab):
    lms = 10.0 ** (lab @ np.linalg.inv(_LMS2LAB_A @ _LMS2LAB_B).T)
    return lms @ np.linalg.inv(_RGB2LMS).T


def reinhard_transfer(content, style):
    """``content`` with the lab mean and standard deviation of ``style``
    per channel, clipped to [0, 1]."""
    c, s = _rgb_to_lab(content), _rgb_to_lab(style)
    cm, cs = c.mean((0, 1)), c.std((0, 1)) + 1e-6
    sm, ss = s.mean((0, 1)), s.std((0, 1)) + 1e-6
    out = (c - cm) / cs * ss + sm
    return np.clip(_lab_to_rgb(out), 0.0, 1.0)


def hist_match(content, style):
    """Each channel of ``content`` given the value of ``style`` at its rank
    (scaled to ``style``'s size)."""
    out = np.empty_like(content)
    for ch in range(content.shape[-1]):
        c = content[..., ch].ravel()
        s = style[..., ch].ravel()
        order = np.argsort(c)
        ranks = np.empty_like(order)
        ranks[order] = np.arange(c.size)
        matched = np.sort(s)[
            np.minimum((ranks * (s.size / c.size)).astype(np.int64), s.size - 1)]
        out[..., ch] = matched.reshape(content.shape[:2])
    return out


def stylize(content, style, method="reinhard", rng=None, alpha=2.0):
    """The transfer (``"reinhard"`` or ``"hist"``), blended with ``content``
    by ``lam = rng.beta(alpha, alpha)`` and clipped; without ``rng`` the
    transfer alone."""
    f = {"reinhard": reinhard_transfer, "hist": hist_match}[method]
    t = f(content, style)
    if rng is None:
        return t
    lam = rng.beta(alpha, alpha)
    return np.clip(lam * t + (1.0 - lam) * content, 0.0, 1.0)
