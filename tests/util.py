"""Shared test helpers."""

from dctz_tpu.core.container import canonical  # noqa: F401
