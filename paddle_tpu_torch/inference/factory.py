"""Engine factory for the serving surface (counterpart of
``paddle_tpu/inference/factory.py``).

``make_engine(model)`` builds the paged engine, the serving default,
with single-dispatch decode on for a dense bf16 or fp32 stack (each
decode step one launch of the decode megakernel K8 and one of the
sampling epilogue K9; ``mega=False`` keeps the per-layer path, which a
``quantize_for_inference`` model takes by default);
``engine="contiguous"`` builds the slot-contiguous ``DecodeEngine``,
which serves prompts longer than the paged prefill's largest bucket and
is the sampling surface (temperature / top-k / top-p). The JAX
package's ``PT_SERVE_ENGINE`` variable has no counterpart: the caller
names the engine.
"""

import math
from typing import Optional

from paddle_tpu_torch.inference.decode_engine import DecodeEngine
from paddle_tpu_torch.inference.paged_engine import PagedDecodeEngine

__all__ = ["make_engine"]


def make_engine(model, engine: str = "paged", *,
                max_slots: int = 8, max_len: Optional[int] = None,
                n_pages: Optional[int] = None,
                page_size: Optional[int] = None,
                steps_per_call: int = 1, **kw):
    """Build the serving engine for ``model``. Paged sizing default:
    128-row pages, enough for every slot to hold a full-length sequence
    (``max_slots * ceil(max_len / page_size)``); the contiguous engine
    takes no page sizing. Remaining kwargs (``device=`` among them)
    pass to the engine's constructor."""
    cap = max_len or model.cfg.max_seq_len
    if engine == "paged":
        page_size = page_size or 128
        if n_pages is None:
            n_pages = max_slots * math.ceil(cap / page_size)
        return PagedDecodeEngine(model, n_pages=n_pages,
                                 max_slots=max_slots, page_size=page_size,
                                 steps_per_call=steps_per_call, **kw)
    if engine == "contiguous":
        if n_pages is not None or page_size is not None:
            raise ValueError("n_pages and page_size size the paged "
                             "engine; engine='contiguous' takes neither")
        return DecodeEngine(model, max_slots=max_slots, max_len=cap,
                            steps_per_call=steps_per_call, **kw)
    raise ValueError(
        f"engine must be 'paged' or 'contiguous', got {engine!r}")
