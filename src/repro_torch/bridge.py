"""Carry parameters between the packages through numpy.

The reference package's parameters, handed over as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, params)`` on the JAX side), become the
port's tensors one to one: same keys, same stacked ``[n_blocks, ...]``
layouts, same values.  Taking numpy keeps JAX out of this package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE


def params_from_numpy(tree: Dict, device=DEFAULT_DEVICE) -> Dict:
    """Nested dict of numpy arrays -> the same nested dict of tensors on
    ``device``."""
    return {
        k: params_from_numpy(v, device) if isinstance(v, dict)
        else torch.from_numpy(np.array(v)).to(device)  # a writable copy
        for k, v in tree.items()
    }
