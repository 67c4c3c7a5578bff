"""Kernel launch-plan autotuning with a persistent per-card cache.

Counterpart of ``paddle_tpu/ops/pallas/autotune.py`` (a copy of its
cache and ``tune``, which the port does not import): ``tune(...)``
measures every candidate plan of a kernel on the real shapes and caches
the fastest under a (kernel, shape-key) key; a kernel launched without
an explicit plan reads the cache (``tune_paged_attention``,
``tune_mega_epilogue`` and ``tune_flash_attention`` fill it). The
semantics follow the JAX module: a cache hit returns ``(hit, {})`` and
builds nothing; ``geom_check(config)`` is consulted first and a truthy
reason skips the candidate unbuilt (``ops/geometry.py`` is the port's
guard); a candidate that raises is skipped; when nothing survives,
``ValueError("autotune(<kernel>): every candidate failed ...;
geometry-refused: ...")``; otherwise ``(best, {config: seconds})``.

What differs on the card:

- **Timing.** JAX times the host's clock around a synced call. For a
  CUDA ``device`` the port times on the device: after the first launch
  (synchronised, so a refused launch or a fault surfaces there) and
  ``warmup`` more (at least one, whose host time sizes the spin), a
  spin kernel (``torch.cuda._sleep``) holds the
  stream while ``iters`` calls are enqueued behind it between two
  ``torch.cuda.Event``\\ s, so they run back to back and the events
  measure the device, not the host's launch rate (K2 runs in about
  8 us, below a call's Python, and a per-call host clock would choose by
  noise). The operands stay in L2 from one call to the next. A CPU
  ``device`` (or none) times the host's clock as JAX does.
- **Cache location.** ``~/.cache/paddle_tpu_torch/autotune.json``;
  ``PT_AUTOTUNE_CACHE`` overrides it, as in JAX.
- **Keys.** Every key holds ``device_key(device)``: the card's name and
  SM count, or ``"cpu"``. A winner measured on one card is never applied
  to another, and a CPU run never writes a card's key.

The kernels read the cache through ``memo()`` dicts keyed by their
shape tuples, so a launch builds no key string and reads no file; every
write or clear of a cache, and ``use_cache``, empties them. ``history``
keeps the last tuning calls' records (timings, refusals, failures).
"""

import collections
import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

__all__ = ["AutotuneCache", "get_cache", "use_cache", "tune", "device_key",
           "memo", "history"]

# the spin that holds the stream while the timed calls are enqueued:
# cycles a second of the SM clock it counts (an H100 boosts to about
# 1.98 GHz, so this errs long), twice the enqueue time, at most a second
_SPIN_HZ = 2.0e9
_SPIN_MAX_S = 1.0

history: collections.deque = collections.deque(maxlen=64)
_MEMOS: List[dict] = []


def _default_path() -> str:
    return os.environ.get(
        "PT_AUTOTUNE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "paddle_tpu_torch",
                     "autotune.json"))


def memo() -> dict:
    """A dict a kernel's plan resolver keeps its cache reads in, keyed by
    its shape tuple; emptied whenever a cache is written or cleared."""
    d: dict = {}
    _MEMOS.append(d)
    return d


def _drop_memos():
    for d in _MEMOS:
        d.clear()


class AutotuneCache:
    """(kernel, shape-key) -> best config, persisted as JSON."""

    def __init__(self, path: Optional[str] = None):
        self.path = path if path is not None else _default_path()
        self._table: Dict[str, list] = {}
        self._loaded = False

    def _load(self):
        if self._loaded:
            return
        self._loaded = True
        try:
            with open(self.path) as f:
                self._table = json.load(f)
        except (OSError, ValueError):
            self._table = {}

    @staticmethod
    def key(kernel: str, **parts) -> str:
        return kernel + "|" + "|".join(
            f"{k}={parts[k]}" for k in sorted(parts))

    def get(self, key: str):
        self._load()
        hit = self._table.get(key)
        return tuple(hit) if isinstance(hit, list) else hit

    def put(self, key: str, config, persist: bool = True):
        self._load()
        self._table[key] = list(config) if isinstance(config, tuple) \
            else config
        _drop_memos()
        if persist:
            try:
                os.makedirs(os.path.dirname(self.path), exist_ok=True)
                tmp = self.path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(self._table, f, indent=0, sort_keys=True)
                os.replace(tmp, self.path)
            except OSError:
                pass  # the cache is an optimisation; never fail the caller

    def clear(self):
        self._table = {}
        self._loaded = True
        _drop_memos()


_GLOBAL: Optional[AutotuneCache] = None


def get_cache() -> AutotuneCache:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = AutotuneCache()
    return _GLOBAL


def use_cache(path: Optional[str] = None) -> AutotuneCache:
    """Make the process's cache the one at ``path`` (None: the default
    path, ``PT_AUTOTUNE_CACHE`` read anew) and return it; the kernels'
    memos are emptied, so the next launches read it."""
    global _GLOBAL
    _GLOBAL = AutotuneCache(path)
    _drop_memos()
    return _GLOBAL


_DEVICE_KEYS: Dict[int, str] = {}


def device_key(device) -> str:
    """The part of a cache key that names the device: ``"cpu"``, or the
    CUDA card's name and SM count (cached per device index)."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _DEVICE_KEYS:
        props = torch.cuda.get_device_properties(idx)
        _DEVICE_KEYS[idx] = (f"{props.name} "
                             f"({props.multi_processor_count} SMs)")
    return _DEVICE_KEYS[idx]


def _host_seconds(build_and_run, config, warmup, iters):
    build_and_run(config)  # build + first run
    for _ in range(warmup):
        build_and_run(config)
    t0 = time.perf_counter()
    for _ in range(iters):
        build_and_run(config)
    return (time.perf_counter() - t0) / iters


def _device_seconds(build_and_run, config, warmup, iters):
    build_and_run(config)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(max(1, warmup)):
        build_and_run(config)
    torch.cuda.synchronize()
    enqueue_s = (time.perf_counter() - t0) / max(1, warmup) * iters
    torch.cuda._sleep(int(min(2.0 * enqueue_s, _SPIN_MAX_S) * _SPIN_HZ))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        build_and_run(config)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def tune(kernel: str, key: str, candidates: Sequence,
         build_and_run: Callable, warmup: int = 1, iters: int = 3,
         cache: Optional[AutotuneCache] = None,
         geom_check: Optional[Callable] = None, device=None):
    """Measure every candidate config and cache the argmin.

    ``build_and_run(config)`` runs the kernel once on the real shapes:
    on a CUDA ``device`` it launches without synchronising (``tune``
    times the device, see the module's docstring); otherwise it returns
    when the result is ready. Configs that raise (a launch the card
    refuses) are skipped. ``geom_check(config)`` is consulted FIRST: a
    truthy return is a static refusal reason and the candidate is
    skipped without being built or timed. Returns (best_config,
    {config: seconds}); the winner lands in the cache under ``key``.
    Each call appends its record to ``history``."""
    cache = cache or get_cache()
    hit = cache.get(key)
    if hit is not None:
        history.append({"kernel": kernel, "key": key, "hit": True,
                        "best": hit, "timings": {}, "refused": {},
                        "failed": {}})
        return hit, {}
    on_card = device is not None and torch.device(device).type == "cuda"
    seconds = _device_seconds if on_card else _host_seconds
    timings: Dict = {}
    refused: Dict = {}
    failed: Dict = {}
    last_exc = None
    for config in candidates:
        ckey = tuple(config) if isinstance(config, (list, tuple)) \
            else config
        if geom_check is not None:
            try:
                reason = geom_check(config)
            except Exception:  # a broken guard must not block tuning
                reason = None
            if reason:
                refused[ckey] = str(reason)
                continue
        try:
            timings[ckey] = seconds(build_and_run, config, warmup, iters)
        except Exception as e:  # a config the card rejects is skipped
            last_exc = e
            failed[ckey] = f"{type(e).__name__}: {e}"
            continue
    best = min(timings, key=timings.get) if timings else None
    history.append({"kernel": kernel, "key": key, "hit": False,
                    "best": best, "timings": dict(timings),
                    "refused": refused, "failed": failed})
    if not timings:
        detail = ""
        if refused:
            detail = "; geometry-refused: " + "; ".join(
                f"{k}: {v}" for k, v in refused.items())
        raise ValueError(f"autotune({kernel}): every candidate failed "
                         f"for key {key}{detail}") from last_exc
    cache.put(key, best)
    return best, timings
