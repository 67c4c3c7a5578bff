"""KV across engines on one host, on the CPU: the port's handoff and
migration paths (``prefill_only``, ``detach_handoff``,
``submit_handoff``, ``kv_bytes``, ``FrontEnd.submit_handoff`` /
``detach_migrate``) and the fleet prefix directory
(``paddle_tpu_torch.serving.disagg``), with a tiny fp32 GPT (2 layers, d
32, vocab 96, weights at std 0.5 from a numpy seed) carried into both
packages by the converter:

- across packages: a JAX ``PagedDecodeEngine(mega=False,
  prefill_only=True)`` hands its requests over the fp32 wire (JAX
  encode, port decode) to the port's paged engine (single-dispatch and
  per-layer) and to its ``DecodeEngine``; the port's prefill-only engine
  hands off (port encode, JAX decode) to a JAX ``mega=False`` engine.
  Every stream equals JAX direct serving token for token; ``meta`` and
  ``kv_bytes`` equal JAX's, and the detached pages agree;
- the port's own: mid-decode migration in the four dense/paged
  pairings (token for token on fp32), the geometry screen at submit, a
  128 -> 256 page repack, the front end's handoff stream and
  ``{"kv": True}`` migration, lossy-wire pages kept out of fleet
  publication, and the fleet directory's cross-replica hit (suffix-only
  prefill), eviction and poison withdrawals, and the withdraw that lands
  during a fetch.

The two JAX engines are built once for the module."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.paged_engine import (
    PagedDecodeEngine as JaxPagedEngine)
from paddle_tpu.models import gpt as jax_gpt
from paddle_tpu.serving import kv_transfer as jkt
from paddle_tpu_torch import native, stats
from paddle_tpu_torch.inference.decode_engine import DecodeEngine
from paddle_tpu_torch.inference.paged_engine import PagedDecodeEngine
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.models.convert import gpt_from_jax_state
from paddle_tpu_torch.serving import FrontEnd
from paddle_tpu_torch.serving import disagg
from paddle_tpu_torch.serving import kv_transfer as kt
from paddle_tpu_torch.testing import faults
from torch_reference_compile import fast_reference_compiles  # noqa: F401

FIELDS = dict(vocab_size=96, max_seq_len=512, d_model=32, n_layers=2,
              n_heads=4)
PAGES, SLOTS, NEW = 16, 4, 8
# fp32 pools of both packages: the same rows up to summation order
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    faults.clear()
    yield
    faults.clear()


def _prompts(seed=1, lengths=(5, 40, 170)):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 96, size=n).tolist() for n in lengths]


@pytest.fixture(scope="module")
def models():
    jmodel = jax_gpt.GPT(jax_gpt.GPTConfig(dtype=jnp.float32, **FIELDS),
                         seed=0)
    rs = np.random.RandomState(0)
    state = {}
    for k, v in sorted(jmodel.state_dict().items()):
        noise = rs.randn(*v.shape).astype(np.float32)
        state[k] = (1.0 + 0.1 * noise) if "scale" in k else 0.5 * noise
    jmodel.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    model = gpt_from_jax_state(gpt.GPTConfig(dtype=torch.float32, **FIELDS),
                               state, device="cpu")
    return jmodel, model


def _prefill(eng, prompts, max_new_tokens=NEW):
    """Submit ``prompts`` to a prefill-only engine and pump it until each
    request holds its first token."""
    reqs = [eng.submit(p, max_new_tokens=max_new_tokens) for p in prompts]
    while not all(r.tokens or r.done for r in reqs):
        eng.step()
        eng.drain()
    return reqs


@pytest.fixture(scope="module")
def jax_runs(models):
    """JAX direct serving of the prompts (mega=False), the JAX
    prefill-only engine's handoffs of them, and the direct engine kept
    as a receiver."""
    jmodel, _ = models
    prompts = _prompts()
    direct = JaxPagedEngine(jmodel, n_pages=PAGES, max_slots=SLOTS,
                            mega=False)
    reqs = [direct.submit(p, max_new_tokens=NEW) for p in prompts]
    direct.run()
    pf = JaxPagedEngine(jmodel, n_pages=PAGES, max_slots=SLOTS,
                        mega=False, prefill_only=True)
    handoffs = [pf.detach_handoff(r) for r in _prefill(pf, prompts)]
    return {"prompts": prompts, "streams": [r.tokens for r in reqs],
            "handoffs": handoffs, "receiver": direct}


def _receiver(model, kind, **kw):
    if kind == "contiguous":
        return DecodeEngine(model, max_slots=SLOTS, max_len=512,
                            device="cpu", **kw)
    return PagedDecodeEngine(model, n_pages=PAGES, max_slots=SLOTS,
                             mega=(kind == "paged_mega"), device="cpu",
                             **kw)


def _wire(encode, decode, meta, k, v, wire="fp32"):
    h, blob = encode(k, v, meta["n_tokens"], wire=wire)
    k2, v2 = decode(h, blob)
    return dict(meta, wire=wire), k2, v2


@pytest.mark.parametrize("kind", ["paged_mega", "paged", "contiguous"])
def test_jax_prefill_hands_off_to_port_engines(models, jax_runs, kind):
    _, model = models
    eng = _receiver(model, kind)
    reqs = [eng.submit_handoff(*_wire(jkt.encode_kv_pages,
                                      kt.decode_kv_pages, *h))
            for h in jax_runs["handoffs"]]
    eng.run()
    assert [r.tokens for r in reqs] == jax_runs["streams"]
    assert all(len(r.tokens) == NEW and not r.failed for r in reqs)


def test_port_prefill_hands_off_to_jax_engine(models, jax_runs):
    _, model = models
    pf = PagedDecodeEngine(model, n_pages=PAGES, max_slots=SLOTS,
                           prefill_only=True, device="cpu")
    stats.reset("serve/")
    reqs = _prefill(pf, jax_runs["prompts"])
    # the role-tagged first-token metric, and no decode dispatch
    assert stats.get("serve/prefill_s") == 3
    assert stats.get("serve/ttft_s") == 0 and pf.steps == 0
    assert pf.kv_bytes == sum(len(t) for t in pf._tables) * (
        2 * 2 * 4 * 128 * 8 * 4)
    handoffs = [pf.detach_handoff(r) for r in reqs]
    assert pf.kv_bytes == 0 and all(r.done for r in reqs)
    jeng = jax_runs["receiver"]
    jreqs = []
    for (meta, k, v), (jmeta, jk, jv) in zip(handoffs,
                                             jax_runs["handoffs"]):
        assert meta == jmeta
        n = meta["n_tokens"]
        for got, want in ((k, jk), (v, jv)):
            assert tuple(got.shape) == want.shape
            rows = got.transpose(1, 2).reshape(2, 4, -1, 8)[:, :, :n]
            np.testing.assert_allclose(
                rows.numpy(), np.asarray(want).transpose(0, 2, 1, 3, 4)
                .reshape(2, 4, -1, 8)[:, :, :n], atol=ATOL)
        jreqs.append(jeng.submit_handoff(*_wire(
            kt.encode_kv_pages, jkt.decode_kv_pages, meta, k, v)))
    jeng.run()
    assert [r.tokens for r in jreqs] == jax_runs["streams"]


def test_kv_bytes_equal_to_jax(models, jax_runs):
    _, model = models
    eng = _receiver(model, "paged")
    jeng = jax_runs["receiver"]
    for e, enc, dec in ((eng, jkt.encode_kv_pages, kt.decode_kv_pages),
                        (jeng, jkt.encode_kv_pages, jkt.decode_kv_pages)):
        for h in jax_runs["handoffs"]:
            e.submit_handoff(*_wire(enc, dec, *h))
        e.step()
        e.drain()
    # the same pages per slot (the JAX receiver's ids differ: its prefix
    # cache holds warm pages from the earlier tests)
    assert [len(t) for t in eng._tables] == [len(t) for t in jeng._tables]
    assert eng.kv_bytes == jeng.kv_bytes > 0
    eng.run()
    jeng.run()
    assert eng.kv_bytes == jeng.kv_bytes == 0


def _migrate(src, dst, prompts, at_steps, wire="fp32", page_size=None):
    """Serve ``prompts`` on ``src``, detach request 0 after ``at_steps``
    steps, carry it over the wire to ``dst`` and finish both. Returns
    (the migrated request on dst, src's requests)."""
    reqs = [src.submit(p, max_new_tokens=NEW) for p in prompts]
    for _ in range(at_steps):
        src.step()
    src.drain()
    meta, k, v = src.detach_handoff(reqs[0])
    assert len(meta["tokens"]) > 1 and reqs[0].done
    moved = dst.submit_handoff(*_wire(kt.encode_kv_pages,
                                      kt.decode_kv_pages, meta, k, v, wire))
    src.run()
    dst.run()
    return moved, reqs


@pytest.mark.parametrize("src_kind, dst_kind", [
    ("paged_mega", "paged_mega"), ("contiguous", "contiguous"),
    ("paged", "contiguous"), ("contiguous", "paged_mega")])
def test_mid_decode_migration(models, jax_runs, src_kind, dst_kind):
    _, model = models
    moved, reqs = _migrate(_receiver(model, src_kind),
                           _receiver(model, dst_kind), jax_runs["prompts"],
                           at_steps=4)
    want = jax_runs["streams"]
    assert moved.tokens == want[0] and not moved.failed
    assert [r.tokens for r in reqs[1:]] == want[1:]


def test_geometry_screen_and_page_repack(models, jax_runs):
    _, model = models
    pf = PagedDecodeEngine(model, n_pages=PAGES, max_slots=SLOTS,
                           prefill_only=True, device="cpu")
    meta, k, v = pf.detach_handoff(_prefill(pf, [jax_runs["prompts"][2]])[0])
    for eng in (_receiver(model, "paged"), _receiver(model, "contiguous")):
        with pytest.raises(ValueError, match="geometry"):
            eng.submit_handoff(meta, k[..., :16, :], v[..., :16, :])
        with pytest.raises(ValueError, match="geometry"):
            eng.submit_handoff(meta, k[:, :, :2], v[:, :, :2])
        with pytest.raises(ValueError, match="inconsistent"):
            eng.submit_handoff(dict(meta, n_tokens=3), k, v)
        assert not eng._waiting
    # a 128-row page sender into a 256-row page pool: the same rows
    big = PagedDecodeEngine(model, n_pages=8, max_slots=SLOTS, page_size=256,
                            device="cpu")
    r = big.submit_handoff(meta, k, v)
    assert tuple(r.kv_pages[0].shape) == (2, 1, 4, 256, 8)
    big.run()
    assert r.tokens == jax_runs["streams"][2]
    # and back: a mid-decode 256-page slot migrates into 128-row pages
    moved, _ = _migrate(
        PagedDecodeEngine(model, n_pages=8, max_slots=SLOTS, page_size=256,
                          device="cpu"),
        _receiver(model, "paged"), jax_runs["prompts"], at_steps=3)
    assert moved.tokens == jax_runs["streams"][0]


def test_frontend_handoff_streams_and_migrates(models, jax_runs):
    _, model = models
    src = FrontEnd(_receiver(model, "paged_mega"), admit_ahead=0)
    sreqs = [src.submit(p, max_new_tokens=NEW) for p in jax_runs["prompts"]]
    for _ in range(4):
        src.step()
    got = src.detach_migrate(sreqs[1])
    assert got["kv"] is True and sreqs[1].status == "migrated"
    assert set(got) == {"kv", "meta", "k", "v"}
    assert got["meta"]["n_tokens"] == len(jax_runs["prompts"][1]) + len(
        got["meta"]["tokens"]) - 1
    dst = FrontEnd(_receiver(model, "contiguous"))
    moved = dst.submit_handoff(*_wire(kt.encode_kv_pages,
                                      kt.decode_kv_pages, got["meta"],
                                      got["k"], got["v"]))
    # the sender's tokens[:-1] come first, then the receiver's harvests
    assert moved._buf == got["meta"]["tokens"][:-1]
    assert list(moved.stream()) == jax_runs["streams"][1]
    assert moved.status == "done"
    src.run()
    assert [s.tokens for s in (sreqs[0], sreqs[2])] == [
        jax_runs["streams"][0], jax_runs["streams"][2]]


@pytest.fixture
def store():
    s = native.TCPStore("127.0.0.1", 0, is_master=True, timeout=10.0)
    try:
        yield s
    finally:
        s.close()


def _fleet_pair(store, model):
    engines = []
    for rid in ("A", "B"):
        eng = PagedDecodeEngine(model, n_pages=PAGES, max_slots=2,
                                device="cpu")
        eng.attach_fleet(disagg.FleetPrefixDirectory(store, rid,
                                                     wire="fp32"))
        engines.append(eng)
    return engines


def test_lossy_wire_pages_never_published(models, store):
    _, model = models
    pf = PagedDecodeEngine(model, n_pages=PAGES, max_slots=SLOTS,
                           prefill_only=True, device="cpu")
    meta, k, v = pf.detach_handoff(_prefill(pf, _prompts(14, (300,)))[0])
    for wire, published in (("int8", 0), ("fp32", 2)):
        de = _receiver(model, "paged")
        de.attach_fleet(disagg.FleetPrefixDirectory(store, f"dc-{wire}",
                                                    wire=wire))
        stats.reset("serve/fleet_prefix_published")
        r = de.submit_handoff(*_wire(kt.encode_kv_pages,
                                     kt.decode_kv_pages, meta, k, v, wire))
        de.run()
        assert r.error is None and len(r.tokens) == NEW
        assert stats.get("serve/fleet_prefix_published") == published
        assert de.fleet_republish() == published
        for digest in list(de.fleet._published):
            de.fleet.withdraw(digest)


def test_fleet_cross_replica_hit_serves_suffix_only(models, store):
    _, model = models
    a, b = _fleet_pair(store, model)
    prompt = _prompts(7, (300,))[0]
    stats.reset("serve/")
    ra = a.submit(prompt, max_new_tokens=NEW)
    a.run()
    assert stats.get("serve/fleet_prefix_published") == 2
    stats.reset("serve/")
    rb = b.submit(prompt, max_new_tokens=NEW)
    b.run()
    assert rb.tokens == ra.tokens
    assert stats.get("serve/fleet_prefix_lookup") == 1
    assert stats.get("serve/fleet_prefix_hit_tokens") == 256
    # the adopted pages made it a local suffix-only prefill
    assert stats.get("serve/prefix_hit_tokens") == 256
    assert stats.get("serve/dispatches/prefill_suffix") == 1
    # a stale descendant revives locally: reclaim B's parent page only
    assert b._prefix.reclaimable_pages == 2 and b._prefix.reclaim(1) == 1
    stats.reset("serve/")
    r2 = b.submit(prompt, max_new_tokens=NEW)
    b.run()
    assert r2.tokens == ra.tokens
    assert stats.get("serve/fleet_prefix_hit_tokens") == 128


def test_fleet_eviction_and_poison_withdraw(models, store):
    _, model = models
    a, b = _fleet_pair(store, model)
    prompt = _prompts(8, (300,))[0]
    ra = a.submit(prompt, max_new_tokens=NEW)
    a.run()
    w0 = stats.get("serve/fleet_prefix_withdrawn")
    assert a._prefix.reclaim(100) == 2
    assert stats.get("serve/fleet_prefix_withdrawn") - w0 == 2
    stats.reset("serve/fleet_prefix_hit_tokens")
    rb = b.submit(prompt, max_new_tokens=NEW)
    b.run()
    assert stats.get("serve/fleet_prefix_hit_tokens") == 0
    assert rb.tokens == ra.tokens                  # cold prefill
    # B published the cold prefill; a poisoned sharer on B withdraws it
    w0 = stats.get("serve/fleet_prefix_withdrawn")
    with faults.inject("engine.poison_logits", "nan", slot=0):
        r2 = b.submit(prompt, max_new_tokens=NEW)
        b.run()
    assert r2.failed
    assert stats.get("serve/fleet_prefix_withdrawn") - w0 == 2
    stats.reset("serve/fleet_prefix_hit_tokens")
    r3 = a.submit(prompt, max_new_tokens=NEW)
    a.run()
    assert stats.get("serve/fleet_prefix_hit_tokens") == 0
    assert r3.tokens == ra.tokens


def test_fleet_fetch_discards_on_mid_fetch_withdraw(store, monkeypatch):
    owner = disagg.FleetPrefixDirectory(store, "own", wire="fp32")
    reader = disagg.FleetPrefixDirectory(store, "rdr", wire="fp32")
    k = torch.randn(2, 1, 4, 128, 8)
    digest = b"\x01" * 20
    owner.publish(digest, k, k)
    got = reader.fetch(digest)
    assert got is not None and torch.equal(got[0], k)
    assert reader.covered([digest, b"\x02" * 20]) == 1
    fetch_blob = kt.fetch_blob

    def racing(store_, key, timeout=5.0):
        out = fetch_blob(store_, key, timeout=timeout)
        owner.withdraw(digest)              # lands mid-fetch
        return out

    monkeypatch.setattr(kt, "fetch_blob", racing)
    assert reader.fetch(digest) is None
    # the discarding fetcher deleted the payload it leased
    with pytest.raises(TimeoutError):
        fetch_blob(store, owner._pkey(digest, 1), timeout=0.05)
    assert not reader.lookup(digest)
