"""incubate (counterpart of ``paddle_tpu/incubate``): the fused
transformer layers and functionals of ``incubate.nn``."""
