"""Global configuration for the PyTorch port: sample dtype and device.

Samples are float32 by default, as in ``probabilit_tpu``; float64 is
available for validation (``set_dtype``, or ``PROBABILIT_TPU_X64=1``
before import).  The device defaults to ``cuda``: the port is built for
the card, and ``set_device("cpu")`` is how a caller (the CPU tests, for
one) asks for the CPU.  Nothing moves to the CPU because a GPU is
missing: on a machine without a card, sampling on the default device
raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch

DEFAULT_DEVICE = torch.device("cuda")

_FLOAT_DTYPE = None
_DEVICE = DEFAULT_DEVICE


def float_dtype():
    """The dtype used for sample tensors and quantiles."""
    global _FLOAT_DTYPE
    if _FLOAT_DTYPE is None:
        x64 = os.environ.get("PROBABILIT_TPU_X64", "0") == "1"
        _FLOAT_DTYPE = torch.float64 if x64 else torch.float32
    return _FLOAT_DTYPE


def set_dtype(dtype):
    """Set the global sample dtype (``torch.float32`` or ``torch.float64``)."""
    global _FLOAT_DTYPE
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
    _FLOAT_DTYPE = dtype
    return dtype


def np_float_dtype():
    """The numpy counterpart of ``float_dtype()``."""
    return np.float64 if float_dtype() == torch.float64 else np.float32


def int_dtype():
    """Integer dtype matched to the float dtype width."""
    return torch.int64 if float_dtype() == torch.float64 else torch.int32


def device():
    """The device that sampling places its tensors on (default ``cuda``)."""
    return _DEVICE


def set_device(dev):
    """Set the sampling device (``"cpu"``, ``"cuda"``, ``"cuda:0"``, ...)."""
    global _DEVICE
    _DEVICE = torch.device(dev)
    return _DEVICE
