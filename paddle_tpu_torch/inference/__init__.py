"""Serving engines of the port (counterpart of
``paddle_tpu/inference``): the paged engine, the slot-contiguous
``DecodeEngine`` and their factory."""
