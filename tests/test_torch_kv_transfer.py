"""The port's KV wire (``paddle_tpu_torch.serving.kv_transfer``) and its
store and socket planes (``paddle_tpu_torch.native``) against the JAX
package's, on the CPU:

- the codec: the same numpy (k, v, n_tokens) through both packages'
  ``encode_kv_pages`` on fp32 and bf16 pools, with and without a tail,
  at block 256 and a block larger than the tensor, on every wire:
  headers equal, blobs byte-identical, and each package decodes the
  other's blob to equal pages; the fault site ``kv_transfer.payload``
  (a bitflipped scale raises in both, a flipped payload byte stays
  inside its block's bound) and the sha256 digest (a mismatch raises;
  ``strict=False`` returns NaN pages);
- the fp8 dtype: torch's e4m3 cast gives ml_dtypes' bytes;
- the store protocol: both packages' ``publish_blob`` leave the same
  keys and values on one dict-backed store, a 2 MB blob round-trips
  through the port's ``TCPStore`` in three chunks, and a withdrawn key
  times out;
- the socket plane across packages: the port's ``KVTransport`` offers
  and the JAX one fetches, and the reverse, over loopback."""

import json
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu import native as jax_native
from paddle_tpu.serving import kv_transfer as jkt
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch import dtypes, native
from paddle_tpu_torch.serving import kv_transfer as kt
from paddle_tpu_torch.testing import faults

SHAPE = (2, 3, 4, 128, 8)       # L, pages, kv heads, page, head dim


@pytest.fixture(autouse=True)
def _no_faults():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


def _pages(seed, pool="float32", shape=SHAPE):
    """(k, v) numpy pages in the pool dtype; k holds values at 2x the
    e4m3 range (the block maxima land on +-448 exactly)."""
    rs = np.random.RandomState(seed)
    k = (3.0 * rs.randn(*shape)).astype(np.float32)
    v = (0.01 * rs.randn(*shape)).astype(np.float32)
    k.reshape(-1)[7], k.reshape(-1)[300] = 896.0, -896.0
    if pool == "bfloat16":
        return k.astype(ml_dtypes.bfloat16), v.astype(ml_dtypes.bfloat16)
    return k, v


def _np(t):
    """A port page tensor as fp32 numpy (bf16 widens exactly)."""
    return t.float().numpy()


@pytest.mark.parametrize("wire", ["fp32", "int8", "fp8"])
@pytest.mark.parametrize("block", [256, 1 << 24])
@pytest.mark.parametrize("n_tokens", [300, 384])
@pytest.mark.parametrize("pool", ["float32", "bfloat16"])
def test_codec_byte_identical_to_jax(pool, n_tokens, block, wire):
    k, v = _pages(n_tokens + block % 7, pool)
    hj, bj = jkt.encode_kv_pages(k, v, n_tokens, wire=wire, block=block,
                                 rid="r1")
    hp, bp = kt.encode_kv_pages(k, v, n_tokens, wire=wire, block=block,
                                rid="r1")
    assert hp == hj
    assert json.dumps(hp) == json.dumps(hj)
    assert bp == bj
    # each package decodes the other's blob to the same pages
    kj, vj = jkt.decode_kv_pages(hp, bp)
    kp, vp = kt.decode_kv_pages(hj, bj)
    assert kp.dtype == dtypes.to_dtype(pool)
    assert np.array_equal(_np(kp), np.asarray(kj, np.float32))
    assert np.array_equal(_np(vp), np.asarray(vj, np.float32))
    if wire != "fp32":
        # the block half step bounds every element; the tail is zero
        kz = np.asarray(k, np.float32).copy()
        if n_tokens % 128:
            kz[:, -1, :, n_tokens % 128:] = 0
        scales = np.frombuffer(
            bp[hp["sections"][0][1]:][:hp["sections"][0][2]], np.float32)
        err = np.abs(_np(kp) - kz).reshape(-1)
        blk = hp["sections"][0][3]
        half = np.repeat(scales, blk)[:err.size] * (
            0.5 if wire == "int8" else 448.0 / 16.0)
        bf16_ulp = np.abs(kz).reshape(-1) * 2.0 ** -8
        assert np.all(err <= half + (bf16_ulp if pool == "bfloat16"
                                     else 0.0) + 1e-6)


def test_codec_takes_torch_tensors_and_keeps_them():
    k, v = _pages(5)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    hj, bj = jkt.encode_kv_pages(k, v, 300, wire="int8")
    hp, bp = kt.encode_kv_pages(tk, tv, 300, wire="int8")
    assert (hp, bp) == (hj, bj)
    # the tail zeroing is wire-local: the caller's tensors are untouched
    assert torch.equal(tk, torch.from_numpy(k))
    bk = tk.to(torch.bfloat16)
    hb, bb = kt.encode_kv_pages(bk, bk, 300, wire="fp32")
    assert hb["pool_dtype"] == "bfloat16"
    assert hb["bytes_wire"] == hb["bytes_logical"] == 2 * bk.numel() * 2


def test_fp8_cast_matches_ml_dtypes():
    rs = np.random.RandomState(0)
    x = np.concatenate([rs.uniform(-448, 448, 65536),
                        [448.0, -448.0, 0.0, -0.0, 1e-9, 2.0 ** -9,
                         3 * 2.0 ** -10]]).astype(np.float32)
    want = x.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    got = torch.from_numpy(x).to(dtypes.float8_e4m3).view(torch.uint8)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.faults
def test_scale_bitflip_raises_in_both_packages():
    k, v = _pages(3, shape=(2, 1, 4, 128, 8))
    # the exponent MSB of the first block scale: ~2^128 out of envelope
    with faults.inject("kv_transfer.payload", "bitflip", offset=3, bit=6):
        hp, bp = kt.encode_kv_pages(k, v, 128, wire="int8")
    with jfaults.inject("kv_transfer.payload", "bitflip", offset=3,
                        bit=6):
        hj, bj = jkt.encode_kv_pages(k, v, 128, wire="int8")
    assert (hp, bp) == (hj, bj)
    for decode in (kt.decode_kv_pages, jkt.decode_kv_pages):
        with pytest.raises(RuntimeError, match="scale-integrity"):
            decode(hp, bp)
    kn, vn = kt.decode_kv_pages(hp, bp, strict=False)
    assert torch.isnan(kn).all() and torch.isnan(vn).all()


@pytest.mark.faults
def test_payload_flip_stays_inside_its_block_bound():
    k, v = _pages(4, shape=(2, 1, 4, 128, 8))
    hc, clean = kt.encode_kv_pages(k, v, 128, wire="int8")
    with faults.inject("kv_transfer.payload", "bitflip", offset=7, bit=6,
                       target="payload"):
        h, blob = kt.encode_kv_pages(k, v, 128, wire="int8")
    assert blob != clean
    k2, _ = kt.decode_kv_pages(h, blob)      # no raise
    kc, _ = kt.decode_kv_pages(hc, clean)
    diff = (k2.double() - kc.double()).abs()
    assert int((diff > 0).sum()) == 1
    # one code moved by at most 2 x qmax steps of its block's scale
    scale = float(np.frombuffer(blob[h["sections"][0][1]:][:4],
                                np.float32)[0])
    assert float(diff.max()) <= 2 * 127 * scale + 1e-6


@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_digest_mismatch_raises_or_poisons(wire):
    k, v = _pages(6, shape=(2, 1, 4, 128, 8))
    h, blob = kt.encode_kv_pages(k, v, 100, wire=wire)
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0x10
    for decode in (kt.decode_kv_pages, jkt.decode_kv_pages):
        with pytest.raises(RuntimeError, match="content-digest"):
            decode(h, bytes(bad))
    kn, vn = kt.decode_kv_pages(h, bytes(bad), strict=False)
    assert kn.shape == (2, 1, 4, 128, 8)
    assert torch.isnan(kn).all() and torch.isnan(vn).all()


def test_wire_format_resolution(monkeypatch):
    monkeypatch.delenv("PT_KV_WIRE", raising=False)
    assert kt.wire_format() == jkt.wire_format() == "int8"
    for w in ("raw", "fp8", "none"):
        assert kt.wire_format(w) == jkt.wire_format(w)
    monkeypatch.setenv("PT_KV_WIRE", "fp8")
    assert kt.wire_format() == "fp8"
    with pytest.raises(ValueError, match="PT_KV_WIRE"):
        kt.wire_format("int4")
    monkeypatch.setenv("PT_KV_TRANSPORT", "store")
    assert kt.kv_transport() == "store" and kt.maybe_transport() is None
    with pytest.raises(ValueError, match="PT_KV_TRANSPORT"):
        kt.kv_transport("pigeon")


class _DictStore:
    """The store protocol on a dict: ``set``, ``get(key, timeout)``
    (TimeoutError when absent), ``delete_key``, ``add``."""

    def __init__(self):
        self.kv = {}

    def set(self, key, value):
        self.kv[key] = value.encode() if isinstance(value, str) else value

    def get(self, key, timeout=30.0):
        if key not in self.kv:
            raise TimeoutError(key)
        return self.kv[key]

    def delete_key(self, key):
        self.kv.pop(key, None)

    def add(self, key, amount=1):
        self.kv[key] = str(int(self.kv.get(key, b"0")) + amount).encode()
        return int(self.kv[key])


def test_store_protocol_equal_to_jax():
    k, v = _pages(7, shape=(2, 8, 4, 128, 32))       # 2 MB fp32 wire
    stores = []
    for mod in (jkt, kt):
        store = _DictStore()
        h, blob = mod.encode_kv_pages(k, v, 1000, wire="fp32")
        mod.publish_blob(store, "h/1", h, blob)
        stores.append(store.kv)
    assert stores[0] == stores[1]
    assert sorted(stores[1]) == ["h/1/c0", "h/1/c1", "h/1/c2", "h/1/meta"]
    # each package reads the other's keys back and withdraws them
    store = _DictStore()
    store.kv = dict(stores[0])
    h2, blob2 = kt.fetch_blob(store, "h/1")
    assert blob2 == b"".join(stores[0][f"h/1/c{i}"] for i in range(3))
    kt.delete_blob(store, "h/1")
    assert store.kv == {}


def test_tcpstore_round_trip_and_withdraw():
    store = native.TCPStore("127.0.0.1", 0, is_master=True, timeout=10.0)
    client = native.TCPStore("127.0.0.1", store.port, timeout=10.0)
    try:
        assert store.port > 0
        k, v = _pages(8, shape=(2, 8, 4, 128, 32))
        h, blob = kt.encode_kv_pages(k, v, 1000, wire="fp32")
        assert len(blob) >= 2 << 20
        kt.publish_blob(store, "t/kv", h, blob)
        h2, blob2 = kt.fetch_blob(client, "t/kv")
        assert blob2 == blob and h2["nchunks"] == 3
        kp, _ = kt.decode_kv_pages(h2, blob2)
        assert np.array_equal(kp.numpy()[:, :, :, :1000 % 128],
                              k[:, :, :, :1000 % 128])
        assert client.add("n", 2) == 2 and store.add("n", 0) == 2
        kt.delete_blob(store, "t/kv")
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            kt.fetch_blob(client, "t/kv", timeout=0.2)
        assert time.monotonic() - t0 < 1.0
        with pytest.raises(TimeoutError):
            client.wait(["absent"], timeout=0.1)
    finally:
        client.close()
        store.close()


def test_p2p_endpoint_frames_and_mailboxes():
    a, b = native.P2PEndpoint(), native.P2PEndpoint()
    try:
        big = bytes(range(256)) * 4096              # 1 MiB
        for tag, payload in ((5, b"x"), (5, b""), (7, big), (5, b"z")):
            a.send("127.0.0.1", b.port, tag, payload)
        assert b.recv(7, timeout=2.0) == big
        assert [b.recv(5, timeout=2.0) for _ in range(3)] == [b"x", b"",
                                                              b"z"]
        with pytest.raises(TimeoutError):
            b.recv(5, timeout=0.0)
        with pytest.raises(ConnectionError):
            a.send("127.0.0.1", 1, 1, b"nobody listens on port 1")
    finally:
        a.close()
        b.close()


@pytest.fixture
def transports():
    """One KVTransport of each package, closed afterwards."""
    if not jax_native.is_available():
        pytest.skip("the JAX package's native library is not built here")
    port_t, jax_t = kt.KVTransport(), jkt.KVTransport()
    try:
        yield port_t, jax_t
    finally:
        port_t.close()
        jax_t.close()


def test_socket_plane_across_packages(transports):
    port_t, jax_t = transports
    k, v = _pages(9)
    h, blob = kt.encode_kv_pages(k, v, 300, wire="int8")
    for owner, fetcher in ((port_t, jax_t), (jax_t, port_t)):
        owner.offer("req/1", h, blob)
        h2, blob2 = fetcher.fetch(*owner.locator(), "req/1", timeout=2.0)
        assert blob2 == blob and h2 == dict(h, nchunks=0)
        with pytest.raises(TimeoutError):
            fetcher.fetch(*owner.locator(), "req/absent", timeout=2.0)
        fetcher.delete(*owner.locator(), "req/1")
        deadline = time.monotonic() + 2.0
        while "req/1" in owner.outbox and time.monotonic() < deadline:
            time.sleep(0.01)
        assert "req/1" not in owner.outbox
        with pytest.raises(TimeoutError):
            fetcher.fetch(*owner.locator(), "req/1", timeout=2.0)


def test_handoff_helpers_fork_on_the_plane():
    store = _DictStore()
    h, blob = kt.encode_kv_pages(*_pages(10), 300, wire="fp8")
    assert kt.send_handoff(store, None, "h/2", h, blob) is None
    h2, blob2 = kt.fetch_handoff(store, None, "h/2")
    assert blob2 == blob
    kt.delete_handoff(store, None, "h/2")
    assert store.kv == {}
    with pytest.raises(TimeoutError, match="no transport"):
        kt.fetch_handoff(store, None, "h/2", kv_ep=["127.0.0.1", 1])
    t = kt.KVTransport()
    try:
        ep = kt.send_handoff(store, t, "h/3", h, blob)
        assert ep == [t.host, t.port] and store.kv == {}
        assert kt.fetch_handoff(store, t, "h/3", kv_ep=ep,
                                timeout=2.0)[1] == blob
    finally:
        t.close()
