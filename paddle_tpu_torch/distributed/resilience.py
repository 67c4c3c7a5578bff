"""The serving fleet's failure types (counterpart of the exception
classes of ``paddle_tpu/distributed/resilience.py``). The retry policy,
deadlines, the guarded store and the collective watchdog land with the
multi-process half of disaggregated serving (ROADMAP item 7b, S4b-2).
"""

__all__ = ["DeadlineExceeded", "StorePartitioned"]


class DeadlineExceeded(TimeoutError):
    """An operation (including all its retries) overran its absolute
    deadline. Subclasses TimeoutError so existing timeout handlers treat
    it uniformly."""


class StorePartitioned(ConnectionError):
    """The control-plane store stopped answering for a whole retry
    budget (router death, network partition, frozen server). Callers in
    the serve loops treat this as "degrade, don't die": skip the beat,
    buffer the result, keep decoding."""
