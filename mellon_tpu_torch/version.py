"""The version of mellon_tpu_torch (counterpart of ``mellon_tpu/version.py``)."""

__version__ = "0.6.0"
