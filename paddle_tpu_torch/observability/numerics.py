"""Training-numerics observability (counterpart of
``paddle_tpu/observability/numerics.py``).

- **capture**: per-layer summaries (sum of squares, amax, non-finite
  count, dtype overflow / underflow counts) of the step's gradients and
  parameter updates, computed on the device and concatenated into ONE
  fp32 vector, so a sampled step costs the host one transfer;
- **NaN provenance**: a layer-major argmax over the per-layer
  non-finite counts, in the same vector: the host learns the first bad
  layer and leaf family;
- **cadence**: ``PT_NUMERICS_EVERY`` (0 = off). At k > 1 off-cadence
  steps compute nothing and return a zeroed vector (tag 0);
- **host plane**: ``Monitor`` unpacks the vector, records ``num/``
  gauges in the stats registry, feeds ``NumericsWatch`` (edge-triggered
  detectors) and a bounded ``NumericsRecorder`` ring that dumps its
  last snapshots when a detector fires.

The layout carries the JAX package's leaf names, so the two packed
vectors compare entry by entry: a flat dict of name -> tensor whose
stacked (L, ...) slabs the caller names (``stacked_keys``; the GPT step
passes ``GPT.slab_entries()``) is read as the JAX stacked state
``{"wte": ..., "_stacked_blocks": <block>}``, whose leaves flatten in
sorted order: the slabs, sorted by name, are families
``<prefix>_stacked_blocks.<j>`` and the other entries, sorted by name,
pool into ``<prefix>(rest)``. The port's layout holds families only:
the JAX layout's quantized-wire buckets and scalars have no producer in
the port.

Capture only reads the gradients and updates the step already made: it
never feeds anything back into the update, so turning it on moves no
bit of the parameters. The fault site ``train.grad_poison``
(``poison_grads``, through ``testing.faults``) plants a NaN or a bit
flip in one layer's gradient before the update.
"""

import json
import math
import os
import sys
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch import stats as stats_lib

__all__ = [
    "COLS", "FAULT_SITE", "STACKED_ENTRY",
    "every", "enabled", "due", "ring_capacity",
    "leaf_raw", "stacked_raw", "pooled_raw",
    "Packer", "Layout", "LayoutBox", "cond_every", "capture_step",
    "add_grad_tree", "grad_families", "poison_grads",
    "Monitor", "NumericsWatch", "NumericsRecorder", "split_out",
]

# raw per-layer columns; everything host-facing (rms, fractions)
# derives from these, so reductions across layers stay sums and maxes
COLS = ("sumsq", "amax", "nonfinite", "overflow", "underflow")
NCOL = len(COLS)
# header: [tag, loss, nonfinite_total, first_bad_layer,
# first_bad_family]; tag 1.0 marks a computed (on-cadence) sample
HEADER = ("tag", "loss", "nonfinite", "first_bad_layer",
          "first_bad_family")
NHDR = len(HEADER)

FAULT_SITE = "train.grad_poison"
# the JAX stacked state's entry name
STACKED_ENTRY = "_stacked_blocks"


def every() -> int:
    """PT_NUMERICS_EVERY: sample every k-th step; 0 disables capture
    (the train step returns its 3-tuple)."""
    try:
        return max(0, int(os.environ.get("PT_NUMERICS_EVERY", "0") or 0))
    except ValueError:
        return 0


def enabled() -> bool:
    return every() > 0


def due(step_count, every_k: Optional[int] = None) -> bool:
    """Whether optimizer step ``step_count`` (before its update) is
    sampled."""
    k = every() if every_k is None else int(every_k)
    return k > 0 and (step_count is None or k <= 1
                      or int(step_count) % k == 0)


def ring_capacity() -> int:
    try:
        return max(1, int(os.environ.get("PT_NUMERICS_RING", "64")))
    except ValueError:
        return 64


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _dump_dir() -> Optional[str]:
    return (os.environ.get("PT_NUMERICS_DIR")
            or os.environ.get("PT_FLIGHT_DIR")
            or os.environ.get("PT_TRACE_DIR"))


# -- raw summaries (on the tensors' device) -----------------------------------

def _limits(dtype) -> Tuple[float, float]:
    """(overflow threshold, underflow threshold) of a float dtype: |x|
    past 90% of its max counts as overflow-at-risk, a nonzero |x| under
    its smallest normal as underflow."""
    if not dtype.is_floating_point:
        return float("inf"), 0.0
    fi = torch.finfo(dtype)
    return 0.9 * float(fi.max), float(fi.tiny)


def leaf_raw(x) -> torch.Tensor:
    """(NCOL,) raw summary of one whole tensor."""
    return stacked_raw(x.reshape(1, -1))[0]


def stacked_raw(x) -> torch.Tensor:
    """(L, NCOL) raw summary of a stacked (L, ...) tensor, reducing over
    every dim but the first."""
    hi, lo = _limits(x.dtype)
    xf = x.detach().float()
    if xf.dim() == 1:
        xf = xf[:, None]
    xf = xf.reshape(xf.shape[0], -1)
    fin = torch.isfinite(xf)
    ax = torch.where(fin, xf.abs(), 0.0)
    # a nonzero magnitude read from the bits, so that a subnormal counts
    # however the compare would treat it
    nz = (xf.view(torch.int32) & 0x7FFFFFFF) != 0
    return torch.stack([
        torch.where(fin, xf * xf, 0.0).sum(1),
        ax.amax(1),
        (~fin).float().sum(1),
        (fin & (ax >= hi)).float().sum(1),
        (fin & nz & (ax < lo)).float().sum(1),
    ], dim=-1)


def pooled_raw(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """(1, NCOL) raw summary pooling several tensors into one family."""
    rows = torch.stack([leaf_raw(x) for x in leaves])
    return torch.stack([rows[:, 0].sum(), rows[:, 1].amax(),
                        rows[:, 2].sum(), rows[:, 3].sum(),
                        rows[:, 4].sum()])[None]


# -- the port's flat dict in the JAX leaf names -------------------------------

def _slabs(grads, stacked_keys) -> List[str]:
    """The slab entries of ``grads``, in the JAX flatten order."""
    return sorted(n for n in (stacked_keys or ()) if n in grads)


def grad_families(grads: Dict[str, torch.Tensor],
                  stacked_keys: Optional[Sequence[str]] = None):
    """``([(JAX name, slab)], [(name, tensor)])``: the entries named in
    ``stacked_keys`` (stacked (L, ...) slabs) in the JAX stacked state's
    flatten order, named ``_stacked_blocks.<j>``, and the other entries
    sorted by name."""
    slabs = _slabs(grads, stacked_keys)
    stacked = [(f"{STACKED_ENTRY}.{j}", grads[n])
               for j, n in enumerate(slabs)]
    plain = [(n, grads[n]) for n in sorted(grads) if n not in slabs]
    return stacked, plain


def add_grad_tree(pk: "Packer", grads: Dict[str, torch.Tensor],
                  stacked_keys: Optional[Sequence[str]] = None,
                  prefix: str = "grad/"):
    """Add one name -> tensor dict to a ``Packer``: every slab of
    ``stacked_keys`` becomes a per-layer family, the rest pools into
    ``<prefix>(rest)``."""
    stacked, plain = grad_families(grads, stacked_keys)
    for name, leaf in stacked:
        per_layer = math.prod(leaf.shape[1:]) if leaf.dim() > 1 else 1
        pk.family(prefix + name, stacked_raw(leaf), per_layer)
    if plain:
        total = sum(max(1, l.numel()) for _, l in plain)
        pk.family(prefix + "(rest)", pooled_raw([l for _, l in plain]),
                  total)


# -- the packed vector --------------------------------------------------------

class Layout:
    """Host-side schema of one packed vector: family names and sizes, so
    the harvested vector decodes without more device traffic."""

    def __init__(self, families):
        self.families = list(families)   # (name, L, per-layer count)
        self.size = NHDR + sum(L * NCOL for _, L, _ in self.families)

    def family_names(self) -> List[str]:
        return [n for n, _, _ in self.families]

    def unpack(self, arr) -> Optional[dict]:
        """Decode one harvested vector into a JSON-ready snapshot; None
        for an off-cadence (zeroed) sample."""
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().double().numpy()
        a = np.asarray(arr, dtype=np.float64).reshape(-1)
        if a.shape[0] != self.size:
            raise ValueError(
                f"packed size {a.shape[0]} != layout {self.size}")
        if a[0] != 1.0:
            return None
        snap: Dict[str, Any] = {
            "loss": float(a[1]),
            "nonfinite": float(a[2]),
            "first_bad_layer": int(a[3]),
            "first_bad_family": int(a[4]),
        }
        names = self.family_names()
        fam_idx = snap["first_bad_family"]
        snap["first_bad_family_name"] = (
            names[fam_idx] if 0 <= fam_idx < len(names) else None)
        off = NHDR
        fams: Dict[str, Any] = {}
        g_ss = g_n = u_ss = u_n = 0.0
        g_amax = u_amax = over_max = under_max = 0.0
        for name, L, cnt in self.families:
            blk = a[off:off + L * NCOL].reshape(L, NCOL)
            off += L * NCOL
            cnt = max(1, cnt)
            fams[name] = {
                "rms": [float(math.sqrt(max(v, 0.0) / cnt))
                        for v in blk[:, 0]],
                "amax": [float(v) for v in blk[:, 1]],
                "nonfinite": [float(v) for v in blk[:, 2]],
                "overflow_frac": [float(v / cnt) for v in blk[:, 3]],
                "underflow_frac": [float(v / cnt) for v in blk[:, 4]],
            }
            over_max = max(over_max, max(fams[name]["overflow_frac"]))
            under_max = max(under_max,
                            max(fams[name]["underflow_frac"]))
            if name.startswith("upd/"):
                u_ss += float(blk[:, 0].sum())
                u_n += cnt * L
                u_amax = max(u_amax, float(blk[:, 1].max()))
            else:
                g_ss += float(blk[:, 0].sum())
                g_n += cnt * L
                g_amax = max(g_amax, float(blk[:, 1].max()))
        snap.update({
            "families": fams,
            "grad_rms": float(math.sqrt(g_ss / g_n)) if g_n else 0.0,
            "grad_amax": g_amax,
            "update_rms": (float(math.sqrt(u_ss / u_n))
                           if u_n else None),
            "overflow_frac_max": over_max,
            "underflow_frac_max": under_max,
        })
        return snap


class LayoutBox:
    """Slot a step builder hangs off its step (``step.numerics_layout``);
    ``Packer.pack`` fills it, so ``Monitor`` can decode harvests."""

    def __init__(self):
        self.layout: Optional[Layout] = None


class Packer:
    """Accumulator for one step's packed vector."""

    def __init__(self):
        self._fams: List[Tuple[str, int, int]] = []
        self._fraw: List[torch.Tensor] = []

    def family(self, name: str, raw, per_layer_count: int):
        if raw.dim() != 2 or raw.shape[1] != NCOL:
            raise ValueError(f"family raw must be (L,{NCOL}), "
                             f"got {tuple(raw.shape)}")
        self._fams.append((str(name), int(raw.shape[0]),
                           int(per_layer_count)))
        self._fraw.append(raw.float())

    def layout(self) -> Layout:
        return Layout(self._fams)

    def pack(self, loss=None, box: Optional[LayoutBox] = None
             ) -> torch.Tensor:
        """Header + every family in one fp32 vector. The header reduces
        the per-layer non-finite counts layer-major, so the FIRST bad
        layer wins and ties go to the earlier family."""
        dev = (self._fraw or [torch.zeros(())])[0].device
        F = len(self._fams)
        if F:
            lmax = max(L for _, L, _ in self._fams)
            bad = torch.stack([
                torch.nn.functional.pad((r[:, 2] > 0).to(torch.int32),
                                        (0, lmax - r.shape[0]))
                for r in self._fraw])                       # (F, lmax)
            flat = bad.t().reshape(-1)                      # layer-major
            any_bad = flat.any()
            first = torch.argmax(flat)
            neg = torch.full((), -1, dtype=first.dtype, device=dev)
            first_layer = torch.where(any_bad, first // F, neg)
            first_fam = torch.where(any_bad, first % F, neg)
            nft = sum(r[:, 2].sum() for r in self._fraw)
        else:
            first_layer = first_fam = torch.full((), -1, device=dev)
            nft = torch.zeros((), device=dev)
        lossv = (torch.as_tensor(loss).detach().float().reshape(()).to(dev)
                 if loss is not None
                 else torch.full((), float("nan"), device=dev))
        header = torch.stack([torch.ones((), device=dev), lossv,
                              torch.as_tensor(nft).float(),
                              first_layer.float(), first_fam.float()])
        packed = torch.cat([header] + [r.reshape(-1)
                                       for r in self._fraw]).float()
        if box is not None:
            box.layout = self.layout()
        return packed


def cond_every(step_count, every_k: int, build: Callable[[], torch.Tensor],
               size: Optional[int] = None, device=None) -> torch.Tensor:
    """``build()`` (-> packed vector) on cadence; off cadence a zeroed
    vector of ``size`` (tag 0.0) without evaluating the stats (built
    once and zeroed where the size is not known yet)."""
    if due(step_count, max(1, int(every_k))):
        return build()
    if size is None:
        return torch.zeros_like(build())
    return torch.zeros(size, device=device)


def capture_step(grads: Dict[str, torch.Tensor], *, loss=None,
                 updates: Optional[Dict[str, torch.Tensor]] = None,
                 step_count=None,
                 stacked_keys: Optional[Sequence[str]] = None,
                 box: Optional[LayoutBox] = None) -> torch.Tensor:
    """One-call capture for the train step: per-layer gradient families
    (+ parameter-update deltas) of the slabs named in ``stacked_keys``
    packed at the PT_NUMERICS_EVERY cadence."""
    def build():
        pk = Packer()
        add_grad_tree(pk, grads, stacked_keys)
        if updates is not None:
            add_grad_tree(pk, updates, stacked_keys, prefix="upd/")
        return pk.pack(loss=loss, box=box)
    size = box.layout.size if box is not None and box.layout else None
    dev = next(iter(grads.values())).device if grads else None
    return cond_every(step_count, max(1, every()), build, size, dev)


def split_out(out):
    """((params, state, loss), packed or None) of a step's return."""
    if isinstance(out, (tuple, list)) and len(out) == 4:
        return tuple(out[:3]), out[3]
    return tuple(out), None


# -- fault injection: train.grad_poison ---------------------------------------

def _corrupt(x, row: int, action: str, bit: int) -> torch.Tensor:
    """A copy of ``x`` (viewed (rows, -1)) with element (row, 0) made NaN
    ('nan') or its fp32 bits XORed with ``1 << bit`` ('bitflip'; bit 30,
    the default, makes a huge but finite value)."""
    flat = x.detach().reshape(x.shape[0] if x.dim() > 1 else 1, -1).clone()
    if action == "bitflip":
        tgt = flat[row, 0].float().reshape(1)
        b = tgt.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        b = b ^ (1 << (bit % 32))
        b = torch.where(b >= 2 ** 31, b - 2 ** 32, b).to(torch.int32)
        bad = b.view(torch.float32)[0]
    else:
        bad = torch.tensor(float("nan"))
    flat[row, 0] = bad.to(flat.dtype)
    return flat.reshape(x.shape)


def _poison_rules():
    from paddle_tpu_torch.testing import faults
    if not faults.enabled():
        return []
    return faults.spec(FAULT_SITE, actions=("nan", "bitflip"))


def poison_grads(grads: Dict[str, torch.Tensor],
                 stacked_keys: Optional[Sequence[str]] = None,
                 step_count=None) -> Dict[str, torch.Tensor]:
    """Fault site ``train.grad_poison``: a NaN or bit flip in one
    layer's gradient before the update consumes it (a new dict; the
    tensors given are not changed). ``stacked_keys`` names the slabs.
    Rule kwargs:

    - ``layer=k``  the layer of the slab (default 0)
    - ``key=sub``  a substring of the entry's JAX name
      (``_stacked_blocks.<j>``, ``wte``, ...) or of its port name
      (``stacked.wqkv``) picking the family; default the first slab
    - ``step=s``   only when the optimizer step counter == s
    - ``bit=b``    the bit for ``bitflip`` (default 30)
    """
    rules = _poison_rules()
    if not rules:
        return grads
    stacked, plain = grad_families(grads, stacked_keys)
    slabs = _slabs(grads, stacked_keys)
    order = ([(jn, pn, True) for (jn, _), pn in zip(stacked, slabs)]
             + [(n, n, False) for n, _ in plain])
    out = dict(grads)
    for kw in rules:
        key = str(kw.get("key", ""))
        hit = next(((jn, pn, st) for jn, pn, st in order
                    if key in jn or key in pn), None)
        if hit is None:
            continue
        if ("step" in kw and step_count is not None
                and int(step_count) != int(kw["step"])):
            continue
        _, name, is_slab = hit
        x = out[name]
        row = int(kw.get("layer", 0)) % int(x.shape[0]) if is_slab else 0
        if not is_slab:
            x = x.reshape(1, -1)
        bad = _corrupt(x, row, str(kw.get("action", "nan")),
                       int(kw.get("bit", 30)))
        out[name] = bad.reshape(out[name].shape)
    return out


# -- host plane: recorder / watch / monitor -----------------------------------

class NumericsRecorder:
    """Bounded ring of the last-N decoded snapshots; ``dump`` writes them
    as pid-suffixed JSON, so the steps leading into a spike survive."""

    def __init__(self, capacity: Optional[int] = None):
        self._ring: deque = deque(maxlen=capacity or ring_capacity())

    def append(self, snap: dict):
        self._ring.append(snap)

    def snapshots(self) -> List[dict]:
        return list(self._ring)

    def __len__(self):
        return len(self._ring)

    def dump(self, reason: str, step=None) -> Optional[dict]:
        if not self._ring:
            return None
        rec = {"reason": str(reason),
               "step": int(step) if step is not None else None,
               "dumped_at": time.time(), "pid": os.getpid(),
               "rank": os.environ.get("PT_PROCESS_ID", "0"),
               "snapshots": list(self._ring)}
        stats_lib.add("num/dumps")
        try:
            d = _dump_dir()
            if d:
                os.makedirs(d, exist_ok=True)
                tag = rec["step"] if rec["step"] is not None else "na"
                path = os.path.join(
                    d, f"numerics_{tag}.{os.getpid()}.json")
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(rec, f)
                os.replace(tmp, path)
                rec["path"] = path
            else:
                print("[numerics] " + json.dumps(rec),
                      file=sys.stderr, flush=True)
        except Exception:
            pass
        return rec


class NumericsWatch:
    """Edge-triggered detectors (one counter tick and one stderr line per
    incident; a detector fires again only after its condition clears):

    - ``nonfinite``      any non-finite gradient/update element, named
      by the first bad layer and family
    - ``loss_spike``     loss z-score against the window's median/MAD
    - ``grad_explosion`` grad-rms z-score against the same
    - ``overflow``       the largest per-family dtype-overflow fraction

    A firing detector dumps the recorder ring."""

    def __init__(self, window: Optional[int] = None,
                 z: Optional[float] = None,
                 overflow_frac: Optional[float] = None,
                 recorder: Optional[NumericsRecorder] = None):
        self.window = int(window
                          or _env_float("PT_NUMERICS_WINDOW", 32))
        self.z = float(z or _env_float("PT_NUMERICS_Z", 6.0))
        self.overflow_frac = float(
            overflow_frac or _env_float("PT_NUMERICS_OVERFLOW", 0.01))
        self.recorder = recorder
        self._loss_hist: deque = deque(maxlen=self.window)
        self._grad_hist: deque = deque(maxlen=self.window)
        self._active: set = set()
        self.alerts: List[dict] = []

    def _fire(self, kind: str, key, msg: str) -> bool:
        if key in self._active:
            return False
        self._active.add(key)
        stats_lib.add(f"num/alert_{kind}")
        self.alerts.append({"t": time.time(), "kind": kind,
                            "msg": msg})
        print(f"[numerics] ALERT {kind}: {msg}", file=sys.stderr,
              flush=True)
        return True

    def _clear(self, key):
        self._active.discard(key)

    def _spiked(self, hist, value: float) -> bool:
        """One-sided robust z-score: above median + z * (1.4826 * MAD),
        with a relative floor on the MAD."""
        if len(hist) < max(4, self.window // 4):
            return False
        med = float(np.median(hist))
        mad = float(np.median(np.abs(np.asarray(hist) - med)))
        sigma = 1.4826 * mad + 0.05 * abs(med) + 1e-12
        return value > med + self.z * sigma

    def observe(self, snap: dict) -> List[str]:
        """Run every detector over one snapshot; returns the kinds that
        fired on this call."""
        fired: List[str] = []
        step = snap.get("step")

        def fire(kind, msg):
            if self._fire(kind, (kind,), msg):
                fired.append(kind)

        loss = snap.get("loss")
        nonfinite = (snap.get("nonfinite", 0) or 0) > 0 or (
            loss is not None and not math.isfinite(loss))
        if nonfinite:
            fam = snap.get("first_bad_family_name")
            fire("nonfinite",
                 f"non-finite at step {step}: layer "
                 f"{snap.get('first_bad_layer')} family {fam}")
        else:
            self._clear(("nonfinite",))

        if loss is not None and math.isfinite(loss):
            if self._spiked(self._loss_hist, loss):
                fire("loss_spike",
                     f"loss {loss:.6g} spiked vs window median "
                     f"{float(np.median(self._loss_hist)):.6g} "
                     f"at step {step}")
            else:
                self._clear(("loss_spike",))
            self._loss_hist.append(loss)

        grms = snap.get("grad_rms")
        if grms is not None and math.isfinite(grms):
            if self._spiked(self._grad_hist, grms):
                fire("grad_explosion",
                     f"grad rms {grms:.6g} exploded vs window median "
                     f"{float(np.median(self._grad_hist)):.6g} "
                     f"at step {step}")
            else:
                self._clear(("grad_explosion",))
            self._grad_hist.append(grms)

        over = snap.get("overflow_frac_max") or 0.0
        if over > self.overflow_frac:
            fire("overflow", f"dtype overflow fraction {over:.4g} > "
                 f"{self.overflow_frac:.4g} at step {step}")
        else:
            self._clear(("overflow",))

        if fired and self.recorder is not None:
            self.recorder.dump(",".join(fired), step=step)
        return fired


class Monitor:
    """Host end of the capture: per sampled step one device-to-host
    transfer of the packed vector, decoded with the step's ``Layout``,
    recorded as ``num/`` gauges and fed to the watch and recorder."""

    def __init__(self, layout=None, every_k: Optional[int] = None,
                 watch: Optional[NumericsWatch] = None,
                 recorder: Optional[NumericsRecorder] = None):
        self._layout_src = layout
        self.every = int(every() if every_k is None else every_k)
        self.recorder = (recorder if recorder is not None
                         else NumericsRecorder())
        self.watch = (watch if watch is not None
                      else NumericsWatch(recorder=self.recorder))
        self.samples = 0

    @classmethod
    def for_step(cls, step_fn, **kw) -> "Monitor":
        """Bind to a builder's step (its ``numerics_layout``)."""
        return cls(layout=getattr(step_fn, "numerics_layout", None),
                   **kw)

    def _layout(self) -> Optional[Layout]:
        src = self._layout_src
        if isinstance(src, LayoutBox):
            return src.layout
        return src

    def due(self, step: int) -> bool:
        return self.every > 0 and (int(step) % self.every) == 0

    def ingest(self, packed, step: int) -> Optional[dict]:
        """Harvest one sampled step; off-cadence calls return None
        without touching the device tensor."""
        if packed is None or not self.due(step):
            return None
        lay = self._layout()
        if lay is None:
            return None
        snap = lay.unpack(packed)               # the one transfer
        if snap is None:
            return None
        snap["step"] = int(step)
        self.samples += 1
        self._gauges(snap)
        self.recorder.append(snap)
        snap["alerts"] = self.watch.observe(snap)
        return snap

    def _gauges(self, snap: dict):
        stats_lib.add("num/samples")
        sv = stats_lib.set_value
        if math.isfinite(snap["loss"]):
            sv("num/loss", snap["loss"])
        sv("num/nonfinite", snap["nonfinite"])
        sv("num/first_bad_layer", snap["first_bad_layer"])
        sv("num/grad_rms", snap["grad_rms"])
        sv("num/grad_amax", snap["grad_amax"])
        sv("num/overflow_frac", snap["overflow_frac_max"])
        sv("num/underflow_frac", snap["underflow_frac_max"])
        if snap.get("update_rms") is not None:
            sv("num/update_rms", snap["update_rms"])
