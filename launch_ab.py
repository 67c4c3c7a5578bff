#!/usr/bin/env python3
"""Kernel launches per decode step of one checkout's paged engines, on one
GPU, to hold two checkouts against each other.

    python3 launch_ab.py DIR      # e.g. build/parent, then .

For gpt3_1p3b (weights from seed 0) through ``make_engine`` with the
single-dispatch default and with ``mega=False``, twice each: 8 prompts
of 128 tokens are admitted, then two 16-step decode dispatches and
their harvest run under torch.profiler. Each prints one JSON line: the
decode steps, the CUDA events in the window (kernels and copies), their
number per step, and their names. Two checkouts whose lines agree
launch the same kernels per decode step.
"""
import collections
import json
import os
import sys


def main(tree):
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference.factory import make_engine
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops import _build
    if not _build.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {_build.__file__}, not {tree}")
    dev = torch.device("cuda", 0)
    model = gpt.GPT(gpt.gpt3_1p3b(), seed=0, device=dev)
    for mega in (True, False):
        for rep in range(2):
            eng = make_engine(model, n_pages=64, max_slots=8,
                              steps_per_call=16, mega=mega)
            rs = np.random.RandomState(2)
            for _ in range(8):
                eng.submit(rs.randint(0, 50304, size=128).tolist(),
                           max_new_tokens=64)
            while eng._waiting:
                eng.step()
            eng.drain()
            torch.cuda.synchronize()
            s0 = eng.steps
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(2):
                    eng.step()
                eng.drain()
                torch.cuda.synchronize()
            steps = (eng.steps - s0) * eng.chunk
            eng.run()
            names = collections.Counter(
                e.name[:60] for e in prof.events()
                if e.device_type == DeviceType.CUDA)
            print(json.dumps({"tree": tree, "mega": mega, "rep": rep,
                              "steps": steps,
                              "launches": sum(names.values()),
                              "per_step": sum(names.values()) / steps,
                              "names": names}), flush=True)
            del eng


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    main(sys.argv[1])
