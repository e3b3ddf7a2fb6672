"""Small host-side helpers."""

from probabilit_tpu_torch.utils.helpers import build_corrmat

__all__ = ["build_corrmat"]
