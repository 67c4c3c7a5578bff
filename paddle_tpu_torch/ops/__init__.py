"""Kernels of the port: each module holds a hand-written CUDA kernel's
wrapper (with its launch counter) beside the plain PyTorch version it
is held against, and a ``*_cost`` function giving the kernel's flops
and HBM bytes for given shapes. The CUDA sources live in
``paddle_tpu_torch/csrc``."""

__all__ = ["launch_counters"]


def launch_counters():
    """Every kernel wrapper of the port, by name. Each wrapper's
    ``launches`` attribute counts the CUDA launches it made (a CPU call
    runs the plain version and counts nothing). ``fused_ce_bwd`` launches
    three kernels per vocab chunk, each with its own counter:
    ``fused_ce_dl`` (the dl pass), ``fused_ce_dx`` (K6), ``fused_ce_dw``
    (K7)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_ce as ce
    from paddle_tpu_torch.ops.decode_attention import decode_attention
    from paddle_tpu_torch.ops.decode_megakernel import (mega_decode_layers,
                                                        mega_logits_sample)
    from paddle_tpu_torch.ops.launch_probe import noop_copy
    from paddle_tpu_torch.ops.layer_norm import fused_layer_norm_fwd
    from paddle_tpu_torch.ops.paged_attention import (
        paged_append_attend, paged_decode_attention)
    from paddle_tpu_torch.ops.quant_matmul import int8_matmul
    return {"flash_attention": fa.flash_attention,
            "paged_append_attend": paged_append_attend,
            "paged_decode_attention": paged_decode_attention,
            "flash_attention_bwd_dkdv": fa.flash_attention_bwd_dkdv,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "fused_ce_fwd": ce.fused_ce_fwd, "fused_ce_dl": ce._dl_pass,
            "fused_ce_dx": ce._dx_chunk, "fused_ce_dw": ce._dw_chunk,
            "decode_attention": decode_attention,
            "int8_matmul": int8_matmul,
            "mega_decode_layers": mega_decode_layers,
            "mega_logits_sample": mega_logits_sample,
            "fused_layer_norm": fused_layer_norm_fwd,
            "noop_copy": noop_copy}
