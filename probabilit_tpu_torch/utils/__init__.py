"""Small host-side helpers (corrmat assembly, argument zipping)."""

from probabilit_tpu_torch.utils.helpers import adjust_minmax_quantiles, build_corrmat, zip_args

__all__ = ["build_corrmat", "zip_args", "adjust_minmax_quantiles"]
