"""The launch probe (kernel K13) and its plain PyTorch version.

Counterpart of the Pallas no-op inside
``paddle_tpu/observability/devprof.py`` ``pallas_launch_tax_s`` (the
``pl.pallas_call`` at devprof.py:291): the CUDA kernel in
``csrc/launch_probe.cu`` copies one (8, 128) fp32 block, so that
``observability.devprof.pallas_launch_tax_s`` can time a hand-written
kernel's launch followed by a scalar readback. Its source note gives the
bound (8 KB of bytes, about 2.4 ns on the H100: the launch is the cost).

``noop_copy(x)`` takes a contiguous fp32 tensor of 1,024 elements (any
shape) and returns a new tensor equal to it. CUDA tensors launch the
kernel; CPU tensors run the plain version, ``x.clone()``, which is also
the one PyTorch call computing the same function.

``launch_floor(device)`` launches an empty kernel of one block of 32
threads, which touches no memory: the card's launch floor, K13's
yardstick for a kernel whose job is to cost one launch. It is a probe
only, on no path of the port.
"""

import ctypes

import torch

from paddle_tpu_torch.ops import _build

__all__ = ["noop_copy", "noop_copy_reference", "noop_copy_cost",
           "launch_floor", "PROBE_ELEMS"]

PROBE_ELEMS = 8 * 128


def noop_copy_reference(x):
    """Plain PyTorch version of K13: a copy."""
    return x.clone()


def noop_copy_cost(elt: int = 4):
    """(flops, HBM bytes) of one K13 call: no arithmetic; the block read
    once and written once."""
    return 0, 2 * PROBE_ELEMS * elt


def _lib():
    lib = _build.load("launch_probe")
    if lib.pt_noop_copy.argtypes is None:
        vp = ctypes.c_void_p
        lib.pt_noop_copy.argtypes = [vp, vp, vp]
        lib.pt_noop_copy.restype = ctypes.c_int
        lib.pt_launch_floor.argtypes = [vp]
        lib.pt_launch_floor.restype = ctypes.c_int
    return lib


def noop_copy(x):
    """K13: a copy of ``x``, a contiguous float32 tensor of
    ``PROBE_ELEMS`` elements. Raises on anything else."""
    if x.dtype != torch.float32 or x.numel() != PROBE_ELEMS:
        raise ValueError(f"noop_copy takes {PROBE_ELEMS} float32 "
                         f"elements, got {x.numel()} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("noop_copy takes a contiguous tensor")
    if x.device.type == "cpu":
        return noop_copy_reference(x)
    if x.data_ptr() % 16:
        raise ValueError("noop_copy takes a 16-byte aligned tensor")
    y = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        noop_copy.launches += 1
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pt_noop_copy(x.data_ptr(), y.data_ptr(), stream)
    _build.check(lib, rc, "noop_copy launch")
    return y


noop_copy.launches = 0


def launch_floor(device):
    """Launch the empty kernel once on ``device`` (a CUDA device) and
    return nothing: the launch floor that K13 is timed against."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"launch_floor runs on a CUDA device, got {device}")
    lib = _lib()
    with torch.cuda.device(device):
        launch_floor.launches += 1
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.pt_launch_floor(stream)
    _build.check(lib, rc, "launch_floor launch")


launch_floor.launches = 0
