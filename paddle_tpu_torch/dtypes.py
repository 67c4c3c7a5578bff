"""Dtype names the port uses (counterpart of ``paddle_tpu/dtypes.py``,
cut to what the serving slice needs)."""

import torch

__all__ = ["float32", "bfloat16", "float16", "float8_e4m3", "int8",
           "int32", "int64", "bool_", "to_dtype", "is_floating"]

float32 = torch.float32
bfloat16 = torch.bfloat16
float16 = torch.float16
# e4m3 (no infinities, +-448): the fp8 KV wire's payload type; the
# conversion rounds to nearest even, as ml_dtypes' does
float8_e4m3 = torch.float8_e4m3fn
int8 = torch.int8
int32 = torch.int32
int64 = torch.int64
bool_ = torch.bool

_NAMES = {
    "float32": float32, "fp32": float32,
    "bfloat16": bfloat16, "bf16": bfloat16,
    "float16": float16, "fp16": float16,
    "float8_e4m3": float8_e4m3, "float8_e4m3fn": float8_e4m3,
    "int8": int8,
    "int32": int32, "int64": int64, "bool": bool_,
}


def to_dtype(d) -> torch.dtype:
    """A ``torch.dtype`` from a dtype or one of the names above."""
    if isinstance(d, torch.dtype):
        return d
    try:
        return _NAMES[str(d)]
    except KeyError:
        raise ValueError(f"unknown dtype {d!r}; known: "
                         f"{sorted(_NAMES)}") from None


def is_floating(d) -> bool:
    return to_dtype(d).is_floating_point
