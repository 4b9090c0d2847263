"""Measurement tools of cfrk_tpu_torch (run as ``python -m``)."""
