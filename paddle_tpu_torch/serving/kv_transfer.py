"""KV-page wire transfer for disaggregated prefill/decode serving
(counterpart of ``paddle_tpu/serving/kv_transfer.py``, under the same
names and byte for byte the same wire).

Prefill replicas run bucketed prefill only and hand the finished KV
pages to a decode replica, which installs them into its own pool and
enters the normal harvest pipeline. This module is the WIRE between
them: a host-side block-scaled codec for the page payload, the chunked
store publish/fetch protocol, the socket plane (``KVTransport``), and
the handoff metadata that lets the decode replica reconstruct the
request's device state (lengths / last token / budget / eos), so decode
continues where prefill stopped.

Wire formats (``PT_KV_WIRE``, default ``int8``):

- ``fp32``: the pool bytes verbatim (bf16 pools travel as bf16) — the
  bit-identity reference: a request served prefill -> transfer -> decode
  produces the token stream of same-replica serving.
- ``int8`` / ``fp8``: block-scaled (one fp32 scale per ``PT_COMM_BLOCK``
  values, int8 +-127 / e4m3 +-448), metered by
  ``serve/kv_transfer_bytes_wire`` against
  ``serve/kv_transfer_bytes_logical``: about 3.94x fewer bytes than an
  fp32 pool at the default block, about 1.97x fewer than a bf16 pool on
  int8. Per-element error is bounded by the block's own half step
  (``amax_block / (2 * qmax)``).

The codec takes CPU torch tensors (numpy arrays too, bfloat16 ones
included) and returns CPU torch tensors in the pool dtype; the header
names that dtype as the JAX package does (``"pool_dtype": "bfloat16"``),
and for the same input the header and blob equal the JAX codec's: every
step is exact in fp32 (bf16 -> fp32, the block maxima, one true division
a value, ``torch.round``'s half-to-even like ``np.round``) or rounds to
nearest even (the e4m3 and bf16 casts, as ml_dtypes').

**Fail-loud scale-integrity guard**: the header carries the
pre-quantization global ``amax``; the decoder validates every block
scale (finite, inside the amax envelope) and every dequantized value
(finite, bounded) and RAISES on violation. The fault site
``kv_transfer.payload`` (``testing/faults.py``) bitflips a scale
(default) or payload byte between encode and publish; a flipped PAYLOAD
byte stays a valid in-envelope code whose damage is bounded by its
block scale. A sha256 digest of the whole blob catches in-transit
corruption on every wire.

Everything here is host-side: nothing touches a GPU.
"""

import collections
import hashlib
import io
import json
import math
import os
import struct
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch import dtypes, native, stats
from paddle_tpu_torch.testing import faults

__all__ = ["wire_format", "encode_kv_pages", "decode_kv_pages",
           "publish_blob", "fetch_blob", "delete_blob", "WIRE_FORMATS",
           "kv_transport", "maybe_transport", "KVTransport",
           "send_handoff", "fetch_handoff", "delete_handoff"]

WIRE_FORMATS = ("fp32", "int8", "fp8")
_FAULT_SITE = "kv_transfer.payload"
# one store value stays under the JAX store's 1MB get buffer, so a blob
# leaves the same keys and values on either package's store
_CHUNK = 768 * 1024
_POOL_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                     torch.float16: "float16"}


def wire_format(wire: Optional[str] = None) -> str:
    """Resolve the KV wire format: explicit arg beats ``PT_KV_WIRE``
    beats the int8 default. ``fp32`` is the bit-identity opt-out."""
    w = wire or os.environ.get("PT_KV_WIRE", "int8").strip().lower()
    if w in ("fp32", "none", "off", "raw"):
        return "fp32"
    if w not in WIRE_FORMATS:
        raise ValueError(
            f"PT_KV_WIRE must be one of {WIRE_FORMATS}, got {w!r}")
    return w


def _block() -> int:
    return int(os.environ.get("PT_COMM_BLOCK", "256"))


def _qmax(wire: str) -> float:
    return 127.0 if wire == "int8" else 448.0


def _host(a) -> torch.Tensor:
    """A private contiguous CPU copy of ``a`` (a torch tensor, or a numpy
    array — a bfloat16 one travels through its bits)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", copy=True).contiguous()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.int16))).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a, order="C"))


def _raw(t: torch.Tensor) -> bytes:
    """``t``'s bytes in memory order (``t`` contiguous)."""
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def _from_raw(b, dtype, shape) -> torch.Tensor:
    return torch.frombuffer(bytearray(b), dtype=torch.uint8).view(
        dtype).reshape(shape)


def _quantize(flat: torch.Tensor, wire: str, block: int):
    """Block-scaled quantization of an fp32 1-D tensor, the JAX codec's
    arithmetic (same block clamp for tiny tensors, same scale floor).
    Returns (payload (nb, block), scales (nb, 1) fp32 numpy, block)."""
    qmax = _qmax(wire)
    n = flat.numel()
    block = max(1, min(block, n))
    nb = -(-n // block)
    padded = torch.zeros((nb * block,), dtype=torch.float32)
    padded[:n] = flat
    blocks = padded.reshape(nb, block)
    amax = blocks.abs().amax(dim=1, keepdim=True).numpy()
    scales = (amax / qmax + 1e-30).astype(np.float32)
    q = blocks / torch.from_numpy(scales)
    if wire == "int8":
        payload = torch.clamp(torch.round(q), -qmax, qmax).to(torch.int8)
    else:
        payload = q.to(dtypes.float8_e4m3)
    return payload, scales, block


def _inject_fault(scales_bytes: bytes, payload_bytes: bytes):
    """Fault site ``kv_transfer.payload``: a matching bitflip rule
    corrupts the scale bytes (default target) or the payload bytes
    between encode and the wire. Inert without a fault plan."""
    if not faults.enabled():
        return scales_bytes, payload_bytes
    for kw in faults.spec(_FAULT_SITE, actions=("bitflip",)):
        off = int(kw.get("offset", 0))
        bit = int(kw.get("bit", 30))
        if str(kw.get("target", "scale")) == "payload":
            b = bytearray(payload_bytes)
            if b:
                b[off % len(b)] ^= 1 << (bit % 8)
            payload_bytes = bytes(b)
        else:
            b = bytearray(scales_bytes)
            if b:
                b[off % len(b)] ^= 1 << (bit % 8)
            scales_bytes = bytes(b)
    return scales_bytes, payload_bytes


def encode_kv_pages(k, v, n_tokens: int, wire: Optional[str] = None,
                    block: Optional[int] = None,
                    rid: Optional[str] = None) -> Tuple[dict, bytes]:
    """Serialize one request's KV pages for the wire.

    ``k``/``v``: (L, npages, Hkv, page, D) host tensors in the pool
    dtype (never modified: the codec works on a copy). Rows at positions
    >= ``n_tokens`` of the last page are ZEROED first — recycled-pool
    garbage the decode side must not inherit (decode overwrites them
    before reading, so this cannot change outputs; it keeps the wire
    deterministic). Returns ``(header, blob)``; the header is
    JSON-serializable and carries the scale-integrity envelope and the
    request's trace context (``rid``) when given."""
    wire = wire_format(wire)
    block = block if block is not None else _block()
    k, v = _host(k), _host(v)
    L, npg, hkv, page, d = (int(x) for x in k.shape)
    tail = int(n_tokens) % page
    if npg and tail:
        k[:, npg - 1, :, tail:, :] = 0
        v[:, npg - 1, :, tail:, :] = 0
    kb, vb = _raw(k), _raw(v)
    logical = len(kb) + len(vb)
    header = {
        "wire": wire, "block": int(block),
        "pool_dtype": _POOL_DTYPE_NAMES[k.dtype],
        "shape": [L, npg, hkv, page, d],
        "n_tokens": int(n_tokens), "bytes_logical": int(logical),
    }
    if rid is not None:
        header["rid"] = str(rid)
    buf = io.BytesIO()
    if wire == "fp32":
        buf.write(kb)
        buf.write(vb)
        header["sections"] = [["k", len(kb)], ["v", len(vb)]]
    else:
        sections = []
        amaxes = {}
        for name, arr in (("k", k), ("v", v)):
            flat = arr.reshape(-1).float()
            amaxes[name] = (float(flat.abs().max()) if flat.numel()
                            else 0.0)
            payload, scales, blk = _quantize(flat, wire, block)
            sb, pb = _inject_fault(scales.tobytes(), _raw(payload))
            buf.write(pb)
            buf.write(sb)
            sections.append([name, len(pb), len(sb), int(blk)])
        header["sections"] = sections
        header["amax"] = amaxes          # the guard envelope
        header["qmax"] = _qmax(wire)
    blob = buf.getvalue()
    header["bytes_wire"] = len(blob)
    # whole-blob content digest: the fp32 wire has no quantization
    # envelope, and a bitflipped migration must fail the fetch loudly
    header["sha256"] = hashlib.sha256(blob).hexdigest()
    stats.add("serve/kv_transfer_bytes_logical", logical)
    stats.add("serve/kv_transfer_bytes_wire", len(blob))
    if len(blob):
        stats.set_value("serve/kv_transfer_ratio", logical / len(blob))
    return header, blob


def decode_kv_pages(header: dict, blob: bytes, strict: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`encode_kv_pages`: (k, v) CPU tensors in the
    pool dtype. On the quantized wire every block scale and every
    dequantized value is validated against the header's amax envelope;
    a violation raises RuntimeError. ``strict=False`` returns
    NaN-poisoned pages instead of raising (callers that prefer the
    engine's own non-finite eviction to surface the failure)."""
    wire = header["wire"]
    shape = tuple(int(x) for x in header["shape"])
    dt = dtypes.to_dtype(header["pool_dtype"])
    n = math.prod(shape)

    def poisoned():
        return (torch.full(shape, float("nan"), dtype=dt),
                torch.full(shape, float("nan"), dtype=dt))

    want = header.get("sha256")
    if want is not None and hashlib.sha256(blob).hexdigest() != want:
        if strict:
            raise RuntimeError(
                "KV blob failed content-digest validation — in-transit "
                "corruption; refusing to install corrupted pages")
        return poisoned()
    if wire == "fp32":
        (_, kb), (_, vb) = header["sections"]
        return (_from_raw(blob[:kb], dt, shape),
                _from_raw(blob[kb:kb + vb], dt, shape))
    wdt = torch.int8 if wire == "int8" else dtypes.float8_e4m3
    out = {}
    off = 0
    bad = None
    for name, pb, sb, blk in header["sections"]:
        payload = _from_raw(blob[off:off + pb], wdt, (-1,))
        off += pb
        scales = np.frombuffer(blob[off:off + sb], np.float32)
        off += sb
        amax = float(header["amax"][name])
        # scale integrity: finite, non-negative, inside the envelope the
        # pre-quantization maxima allow (4x slack); a flipped high bit
        # lands far outside
        smax = amax / float(header["qmax"]) + 1e-6
        if (not np.all(np.isfinite(scales)) or np.any(scales < 0)
                or np.any(scales > 4.0 * smax + 1e-30)):
            bad = f"corrupted block scale in {name!r} section"
        deq = (payload.float().reshape(-1, blk)
               * torch.from_numpy(scales.copy()).reshape(-1, 1)
               ).reshape(-1)[:n]
        if not bool(torch.isfinite(deq).all()) or (
                deq.numel() and float(deq.abs().max()) > 4.0 * amax + 1e-6):
            bad = bad or f"dequantized {name!r} outside amax envelope"
        out[name] = deq.reshape(shape).to(dt)
    if bad is not None:
        if strict:
            raise RuntimeError(
                f"KV wire failed scale-integrity validation ({bad}); "
                f"fault site {_FAULT_SITE!r} — refusing to install "
                "corrupted pages")
        return poisoned()
    return out["k"], out["v"]


# ---------------------------------------------------------------------------
# Chunked store transport
# ---------------------------------------------------------------------------

def publish_blob(store, key: str, header: dict, blob: bytes):
    """Write ``header`` + ``blob`` under ``key`` on the store, blob split
    into <1MB chunks. The meta key is written LAST so a reader that sees
    it can fetch every chunk — a writer killed mid-transfer leaves no
    meta key and therefore no torn read."""
    nchunks = -(-len(blob) // _CHUNK) if blob else 0
    for i in range(nchunks):
        store.set(f"{key}/c{i}", blob[i * _CHUNK:(i + 1) * _CHUNK])
    meta = dict(header, nchunks=nchunks)
    store.set(f"{key}/meta", json.dumps(meta))


def fetch_blob(store, key: str, timeout: float = 5.0
               ) -> Tuple[dict, bytes]:
    """Read back one published blob (meta + chunks). Raises TimeoutError
    when the meta key is absent (transfer incomplete or withdrawn)."""
    meta = json.loads(store.get(f"{key}/meta", timeout=timeout))
    parts = [store.get(f"{key}/c{i}", timeout=timeout)
             for i in range(int(meta["nchunks"]))]
    return meta, b"".join(parts)


def delete_blob(store, key: str, nchunks: Optional[int] = None):
    """Withdraw a published blob: the meta key FIRST (no new readers),
    then the chunks."""
    if nchunks is None:
        try:
            nchunks = int(json.loads(
                store.get(f"{key}/meta", timeout=0.05))["nchunks"])
        except (TimeoutError, ValueError, KeyError):
            nchunks = 0
    try:
        store.delete_key(f"{key}/meta")
        for i in range(int(nchunks)):
            store.delete_key(f"{key}/c{i}")
    except (RuntimeError, ConnectionError):
        pass                            # withdraw is best-effort


# ---------------------------------------------------------------------------
# Store-bypassing socket transport
# ---------------------------------------------------------------------------
#
# On the default ``PT_KV_TRANSPORT=socket`` plane, handoff and migration
# blobs move over direct replica-to-replica ``native.P2PEndpoint``
# sockets instead of store chunks: the sender keeps each encoded blob in
# a bounded outbox and answers tag-addressed FETCH requests; only the
# sender's ``[host, port]`` locator travels in the handoff message. The
# codec (and with it the digest and the scale guard) is the store
# path's: only the carrier changes.
#
# One framed P2P message per direction:
#
#   control (tag 0, JSON):  {"op": "fetch", "key", "host", "port", "tag"}
#                           {"op": "del",   "key"}
#   reply  (requester tag): u64 header_len (big-endian) + header JSON +
#                           blob; header_len == 0 encodes a MISS (the
#                           requester raises TimeoutError — the same
#                           retryable signal as an absent store meta key)

_CTRL_TAG = 0


def kv_transport(mode: Optional[str] = None) -> str:
    """Resolve the KV data plane: ``socket`` (default — direct
    replica-to-replica P2P) or ``store`` (the chunked store path). Must
    agree fleet-wide: a store-mode receiver cannot fetch a socket-mode
    sender's blob."""
    m = (mode or os.environ.get("PT_KV_TRANSPORT", "socket")) \
        .strip().lower()
    if m not in ("socket", "store"):
        raise ValueError(
            f"PT_KV_TRANSPORT must be socket|store, got {m!r}")
    return m


def serve_host() -> str:
    """The host peers dial this replica's KV endpoint on
    (``PT_SERVE_HOST``, default loopback — single-host fleets)."""
    return os.environ.get("PT_SERVE_HOST", "127.0.0.1")


def maybe_transport(mode: Optional[str] = None
                    ) -> Optional["KVTransport"]:
    """A `KVTransport` when the socket plane is selected; None otherwise
    (and when no listen socket can be opened: callers then use the store
    path)."""
    if kv_transport(mode) != "socket" or not native.is_available():
        return None
    try:
        return KVTransport()
    except RuntimeError:
        return None


class KVTransport:
    """One replica's end of the socket KV data plane: a
    ``native.P2PEndpoint`` (ephemeral port), a bounded blob outbox, and
    the fetch/del control protocol above.

    A daemon pump thread answers peers' control messages, so fetches are
    served while the owning serve loop is inside a long ``step()``.
    Every endpoint/outbox touch is serialized by one lock; :meth:`fetch`
    also pumps while it waits, so two replicas fetching from each other
    cannot deadlock. Call :meth:`close` to stop the thread and the
    endpoint."""

    MAX_OUTBOX = 32             # evicted blobs degrade to handoff-failed

    def __init__(self, port: int = 0):
        self.ep = native.P2PEndpoint(port)
        self.host = serve_host()
        self.port = self.ep.port
        self.outbox = collections.OrderedDict()   # key -> (header, blob)
        self._tag = 1 << 32     # reply tags; 0 is the control tag
        self._lock = threading.RLock()
        self._closed = False
        self._thread = threading.Thread(
            target=self._pump_loop, name=f"kv-transport-{self.port}",
            daemon=True)
        self._thread.start()

    def locator(self) -> Tuple[str, int]:
        return (self.host, self.port)

    # -- sender side ----------------------------------------------------
    def offer(self, key: str, header: dict, blob: bytes):
        with self._lock:
            self.outbox[key] = (dict(header, nchunks=0), bytes(blob))
            self.outbox.move_to_end(key)
            while len(self.outbox) > self.MAX_OUTBOX:
                self.outbox.popitem(last=False)
                stats.add("serve/kv_transport_evicted")
        stats.add("serve/kv_transport_offers")

    def withdraw(self, key: str):
        with self._lock:
            self.outbox.pop(key, None)

    def _pump_loop(self):
        while not self._closed:
            try:
                n = self.pump()
            except Exception:           # a poisoned frame never kills it
                n = 0
            time.sleep(0.002 if n else 0.02)

    def pump(self, budget: int = 8) -> int:
        """Answer up to ``budget`` queued control messages (non-blocking);
        returns how many were handled. A reply the requester can no
        longer receive is dropped — it times out and re-places."""
        handled = 0
        for _ in range(budget):
            with self._lock:
                if self._closed:
                    return handled
                try:
                    raw = self.ep.recv(_CTRL_TAG, timeout=0.0)
                except TimeoutError:
                    return handled
                handled += 1
                try:
                    msg = json.loads(raw)
                except ValueError:
                    continue
                if msg.get("op") == "del":
                    self.outbox.pop(msg.get("key"), None)
                    continue
                if msg.get("op") != "fetch":
                    continue
                ent = self.outbox.get(msg.get("key"))
                if ent is None:
                    payload = struct.pack(">Q", 0)
                    stats.add("serve/kv_transport_misses")
                else:
                    header, blob = ent
                    hj = json.dumps(header).encode()
                    payload = struct.pack(">Q", len(hj)) + hj + blob
                    stats.add("serve/kv_transport_bytes_socket", len(blob))
                try:
                    self.ep.send(msg["host"], int(msg["port"]),
                                 int(msg["tag"]), payload)
                except (ConnectionError, BrokenPipeError, KeyError,
                        ValueError, TypeError):
                    pass
        return handled

    # -- receiver side --------------------------------------------------
    def fetch(self, host: str, port: int, key: str,
              timeout: float = 5.0) -> Tuple[dict, bytes]:
        """Fetch ``key`` from the owner at ``host:port``. Raises
        TimeoutError on an unreachable/evicted/absent blob — the same
        retryable contract as :func:`fetch_blob`."""
        with self._lock:
            self._tag += 1
            tag = self._tag
        ctrl = json.dumps({"op": "fetch", "key": key, "host": self.host,
                           "port": self.port, "tag": tag}).encode()
        try:
            with self._lock:
                self.ep.send(host, int(port), _CTRL_TAG, ctrl)
        except (ConnectionError, BrokenPipeError) as e:
            raise TimeoutError(
                f"kv socket fetch({key}): owner {host}:{port} "
                f"unreachable: {e}") from e
        deadline = time.monotonic() + timeout
        while True:
            self.pump()         # keep answering peers while we wait
            try:
                reply = self.ep.recv(tag, timeout=0.05)
                break
            except TimeoutError:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"kv socket fetch({key}) from {host}:{port} "
                        f"timed out after {timeout}s") from None
        hlen = struct.unpack(">Q", reply[:8])[0]
        if hlen == 0:
            raise TimeoutError(
                f"kv socket fetch({key}): blob absent at owner "
                f"{host}:{port} (withdrawn or evicted)")
        header = json.loads(reply[8:8 + hlen])
        blob = reply[8 + hlen:]
        stats.add("serve/kv_transport_bytes_socket", len(blob))
        return header, blob

    def delete(self, host: str, port: int, key: str):
        """Best-effort del notice to the owner (fire-and-forget)."""
        try:
            with self._lock:
                self.ep.send(host, int(port), _CTRL_TAG,
                             json.dumps({"op": "del",
                                         "key": key}).encode())
        except (ConnectionError, BrokenPipeError):
            pass

    def close(self):
        self._closed = True
        self._thread.join(timeout=5.0)
        with self._lock:
            self.outbox.clear()
            self.ep.close()


# -- transport-forking handoff helpers (the serve loops' one entry) ---------

def send_handoff(store, transport: Optional[KVTransport], key: str,
                 header: dict, blob: bytes):
    """Publish a handoff/migration blob on the configured data plane.
    Returns the locator the receiving replica fetches from:
    ``[host, port]`` = the socket plane, ``None`` = the chunked store
    path."""
    if transport is not None:
        transport.offer(key, header, blob)
        return list(transport.locator())
    stats.add("serve/kv_transport_bytes_store", len(blob))
    publish_blob(store, key, header, blob)
    return None


def fetch_handoff(store, transport: Optional[KVTransport], key: str,
                  kv_ep=None, timeout: float = 5.0) -> Tuple[dict, bytes]:
    """Fetch a handoff blob from wherever ``kv_ep`` says it lives.
    Raises TimeoutError (retryable) when absent on either plane,
    including a socket locator with no local transport."""
    if kv_ep:
        if transport is None:
            raise TimeoutError(
                f"handoff {key} lives on the socket plane at "
                f"{kv_ep[0]}:{kv_ep[1]} but this replica has no "
                f"transport (PT_KV_TRANSPORT mismatch)")
        return transport.fetch(kv_ep[0], int(kv_ep[1]), key,
                               timeout=timeout)
    header, blob = fetch_blob(store, key, timeout=timeout)
    stats.add("serve/kv_transport_bytes_store", len(blob))
    return header, blob


def delete_handoff(store, transport: Optional[KVTransport], key: str,
                   kv_ep=None, nchunks: Optional[int] = None):
    """Withdraw an installed handoff blob from its plane."""
    if kv_ep:
        if transport is not None:
            transport.delete(kv_ep[0], int(kv_ep[1]), key)
        return
    delete_blob(store, key, nchunks=nchunks)
