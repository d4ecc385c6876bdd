"""The one copy to the host of values that may live on the card.

The JAX package reads device arrays into numpy with ``np.asarray``; a CUDA
tensor refuses that (``TypeError``), so every host-side consumer in the
port (trajectory fitting, metrics, plots, frames) goes through here.
"""

from __future__ import annotations

import numpy as np
import torch


def to_numpy(x) -> np.ndarray:
    """A numpy array of a tensor on any device, a numpy array, a sequence
    or a number."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
