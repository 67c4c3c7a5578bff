"""Deterministic fault-injection harness (a copy of
``paddle_tpu/testing/faults.py``).

A process-global registry of fault rules that runtime code consults at
named **sites**. With no rules installed every site is one boolean
check, so the serving hot path pays nothing.

Rules are selected by a deterministic per-site call index, never by a
random draw, so a fault plan replays identically run after run:

    rule fires on calls  ``after <= index < after + count``   (0-based)

Install rules three ways:

1. Context manager (tests)::

       from paddle_tpu_torch.testing import faults
       with faults.inject("engine.poison_logits", "nan", slot=1):
           ...

2. Programmatic (scoped manually)::

       faults.install_rule("engine.poison_logits", "nan", after=3)
       ...
       faults.clear()

3. Environment: ``PT_FAULTS`` holds ``;``-separated rules, each
   ``site:action[:key=value[,key=value...]]``, installed by
   :func:`install_from_env` (a process that honours the variable calls
   it once at start)::

       PT_FAULTS="engine.poison_logits:nan:slot=1,after=2"

Actions:

    ``delay``     sleep ``seconds`` (default 0.1) before the op proceeds
    ``raise``     raise ``exc`` (TimeoutError | ConnectionError | OSError |
                  RuntimeError | BrokenPipeError; default TimeoutError)
    ``drop``      tell the caller to silently skip the op
                  (:func:`fire` returns ``"drop"``)
    ``kill``      ``os._exit(code)`` (default 1)
    ``nan``       poison a float payload with NaN (:func:`transform` and
                  :func:`slot_mask` sites)
    ``bitflip``   flip bit ``bit`` of byte ``offset`` in a bytes payload
                  or a file (:func:`transform` / :func:`corrupt_file`)
    ``truncate``  cut a bytes payload / file to ``keep`` bytes (default
                  half its length)

Sites wired into the port:

    engine.poison_logits  DecodeEngine / PagedDecodeEngine
                          (:func:`slot_mask`, one call index per decode
                          dispatch): the named slots' logits become NaN
                          for every step of that dispatch, and the
                          non-finite guard evicts their requests
"""

import os
import threading
import time
from typing import Dict, List, Optional

__all__ = ["inject", "install_rule", "install_from_env", "clear",
           "reset_counts", "enabled", "fire", "transform", "slot_mask",
           "spec", "corrupt_file", "Rule"]

_EXCEPTIONS = {
    "TimeoutError": TimeoutError,
    "ConnectionError": ConnectionError,
    "OSError": OSError,
    "RuntimeError": RuntimeError,
    "BrokenPipeError": BrokenPipeError,
}

_ACTIONS = ("delay", "raise", "drop", "kill", "nan", "bitflip", "truncate")

_lock = threading.Lock()
_rules: List["Rule"] = []
_counts: Dict[str, int] = {}
_enabled = False  # mirrored flag so disabled sites cost one attribute read


class Rule:
    """One fault rule: fires at ``site`` on call indices
    ``[after, after + count)``."""

    __slots__ = ("site", "action", "kw", "after", "count", "fired")

    def __init__(self, site: str, action: str, after: int = 0,
                 count: Optional[int] = None, **kw):
        if action not in _ACTIONS:
            raise ValueError(f"unknown fault action {action!r} "
                             f"(one of {_ACTIONS})")
        self.site = site
        self.action = action
        self.after = int(after)
        self.count = None if count is None else int(count)
        self.kw = kw
        self.fired = 0

    def matches(self, site: str, index: int) -> bool:
        if site != self.site:
            return False
        if index < self.after:
            return False
        return self.count is None or index < self.after + self.count

    def __repr__(self):
        return (f"Rule({self.site}:{self.action} after={self.after} "
                f"count={self.count} {self.kw})")


def enabled() -> bool:
    """Cheap gate for hot paths: True iff any rule is installed."""
    return _enabled


def install_rule(site: str, action: str, **kw) -> Rule:
    global _enabled
    rule = Rule(site, action, **kw)
    with _lock:
        _rules.append(rule)
        _enabled = True
    return rule


def remove_rule(rule: Rule):
    global _enabled
    with _lock:
        if rule in _rules:
            _rules.remove(rule)
        _enabled = bool(_rules)


def clear():
    """Remove every rule and reset all per-site call counters."""
    global _enabled
    with _lock:
        del _rules[:]
        _counts.clear()
        _enabled = False


def reset_counts(site: Optional[str] = None):
    """Reset per-site call counters, keeping installed rules: all sites
    when ``site`` is None, else just that one. :class:`inject` resets
    only ITS site on entry (fresh=True default) so a fault plan replays
    identically however many injects ran before it — without rewinding
    the firing windows of rules installed for other sites."""
    with _lock:
        if site is None:
            _counts.clear()
        else:
            _counts.pop(site, None)


class inject:
    """Context manager installing one rule for the ``with`` body.

        with faults.inject("p2p.send", "drop", after=1, count=1):
            ...

    Entry resets the call counter of ITS site only, so ``after=``
    never counts calls from earlier inject blocks: each inject block
    replays identically by construction, and a nested inject for a
    different site leaves the outer rule's firing window untouched. Pass ``fresh=False`` to opt
    out and keep accumulated indices — only meaningful when composing
    with rules installed via :func:`install_rule`, whose firing windows
    are anchored to the existing counters."""

    def __init__(self, site: str, action: str, fresh: bool = True,
                 **kw):
        self._args = (site, action, kw)
        self._fresh = fresh
        self._rule = None

    def __enter__(self) -> Rule:
        site, action, kw = self._args
        if self._fresh:
            reset_counts(site)
        self._rule = install_rule(site, action, **kw)
        return self._rule

    def __exit__(self, *exc):
        remove_rule(self._rule)
        return False


def install_from_env(env: Optional[Dict[str, str]] = None) -> int:
    """Parse ``PT_FAULTS`` and install its rules; returns how many."""
    spec = (env or os.environ).get("PT_FAULTS", "").strip()
    if not spec:
        return 0
    n = 0
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise ValueError(f"PT_FAULTS rule {part!r}: want "
                             f"site:action[:k=v,...]")
        site, action = fields[0], fields[1]
        kw = {}
        if len(fields) > 2 and fields[2]:
            for item in fields[2].split(","):
                k, _, v = item.partition("=")
                try:
                    kw[k] = int(v)
                except ValueError:
                    try:
                        kw[k] = float(v)
                    except ValueError:
                        kw[k] = v
        install_rule(site, action, **kw)
        n += 1
    return n


def _next_index(site: str) -> int:
    with _lock:
        idx = _counts.get(site, 0)
        _counts[site] = idx + 1
        return idx


def _matching(site: str) -> List[Rule]:
    idx = _next_index(site)
    with _lock:
        hits = [r for r in _rules if r.matches(site, idx)]
        for r in hits:
            r.fired += 1
    return hits


def fire(site: str) -> Optional[str]:
    """Consult the plan at a control-flow site. May sleep, raise, or kill
    the process; returns ``"drop"`` when the caller should silently skip
    the guarded operation, else None."""
    if not _enabled:
        return None
    outcome = None
    for rule in _matching(site):
        act = rule.action
        if act == "delay":
            time.sleep(float(rule.kw.get("seconds", 0.1)))
        elif act == "raise":
            exc = _EXCEPTIONS.get(str(rule.kw.get("exc", "TimeoutError")),
                                  TimeoutError)
            raise exc(f"injected fault at {site!r}")
        elif act == "drop":
            outcome = "drop"
        elif act == "kill":
            os._exit(int(rule.kw.get("code", 1)))
        # payload actions are inert at control-flow sites
    return outcome


def transform(site: str, value):
    """Consult the plan at a payload site: returns ``value``, possibly
    corrupted (bytes: bitflip/truncate; float arrays: nan)."""
    if not _enabled:
        return value
    for rule in _matching(site):
        act = rule.action
        if act == "bitflip" and isinstance(value, (bytes, bytearray)):
            b = bytearray(value)
            if b:
                off = int(rule.kw.get("offset", len(b) // 2)) % len(b)
                b[off] ^= 1 << (int(rule.kw.get("bit", 0)) % 8)
            value = bytes(b)
        elif act == "truncate" and isinstance(value, (bytes, bytearray)):
            keep = int(rule.kw.get("keep", len(value) // 2))
            value = bytes(value[:keep])
        elif act == "nan":
            import numpy as np
            arr = np.array(value, copy=True)
            if arr.size and np.issubdtype(arr.dtype, np.floating):
                arr.reshape(-1)[:max(1, int(rule.kw.get("n", 1)))] = np.nan
            value = arr
        elif act == "delay":
            time.sleep(float(rule.kw.get("seconds", 0.1)))
        elif act == "raise":
            exc = _EXCEPTIONS.get(str(rule.kw.get("exc", "TimeoutError")),
                                  TimeoutError)
            raise exc(f"injected fault at {site!r}")
        elif act == "kill":
            os._exit(int(rule.kw.get("code", 1)))
    return value


def slot_mask(site: str, n: int):
    """Per-slot poison mask for batch engines: an (n,) bool numpy array,
    True for the slots a matching ``nan`` rule names (``slot=k`` or
    ``slots="0|2"``; no slot key → all). One call index per dispatch."""
    import numpy as np
    mask = np.zeros((n,), bool)
    if not _enabled:
        return mask
    for rule in _matching(site):
        if rule.action != "nan":
            continue
        if "slot" in rule.kw:
            mask[int(rule.kw["slot"]) % n] = True
        elif "slots" in rule.kw:
            for s in str(rule.kw["slots"]).split("|"):
                mask[int(s) % n] = True
        else:
            mask[:] = True
    return mask


def spec(site: str, actions=None) -> List[Dict]:
    """Consult the plan at an IN-GRAPH payload site: returns the kw dicts
    (plus ``"action"``) of matching rules instead of applying them — for
    sites inside traced/jitted code, where the payload is a tracer and the
    corruption must be expressed as graph ops (bit-xor on a bitcast) by
    the caller. Consumes one call index, like every other site; traced
    sites are consulted when the program is TRACED, so the rule fires per
    compilation, not per step (documented at ``collective.quant_payload``).
    ``actions`` optionally filters to a subset of rule actions."""
    if not _enabled:
        return []
    out = []
    for rule in _matching(site):
        if actions is None or rule.action in actions:
            out.append(dict(rule.kw, action=rule.action))
    return out


def corrupt_file(site: str, path: str):
    """File-corruption site: applies matching bitflip/truncate rules to
    the file at ``path`` in place (used by checkpoint save to simulate
    post-write disk corruption that verification must catch). Also a
    direct test helper: ``corrupt_file`` with a one-shot ``inject``."""
    if not _enabled or not os.path.exists(path):
        return
    for rule in _matching(site):
        if rule.action == "truncate":
            size = os.path.getsize(path)
            keep = int(rule.kw.get("keep", size // 2))
            with open(path, "r+b") as f:
                f.truncate(keep)
        elif rule.action == "bitflip":
            with open(path, "r+b") as f:
                data = bytearray(f.read())
                if data:
                    off = int(rule.kw.get("offset",
                                          len(data) // 2)) % len(data)
                    data[off] ^= 1 << (int(rule.kw.get("bit", 0)) % 8)
                    f.seek(0)
                    f.write(data)
        elif rule.action == "kill":
            os._exit(int(rule.kw.get("code", 1)))
