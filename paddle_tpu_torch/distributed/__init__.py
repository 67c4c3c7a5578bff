"""Distributed runtime pieces of the port (counterpart of
``paddle_tpu/distributed``): so far the serving fleet's exception types
(``resilience``)."""
