"""Speculative decoding (``speculative_k``) in the port's serving engines
against the JAX package's, on the CPU, with fp32 weights at std 0.5 from
numpy seeds (the 2-layer d 32 fixture of the engine parity tests):

- ``prompt_lookup_draft`` and ``spec_accept`` equal to the JAX functions
  on int32 inputs, with eos, budget and inactive cases;
- the contiguous engine (``DecodeEngine``) against JAX
  ``DecodeEngine(speculative_k=...)``: streams, every dispatch's packed
  (predictions, count, non-finite) record and the history rows
  [0, lengths] exactly, the caches within 1e-4; with an eos inside an
  accepted run; the int8 engine's streams against JAX's int8 engine;
- the paged engine, single-dispatch (K8 and K9's plain versions) and per
  layer (K2''s), against JAX ``PagedDecodeEngine(mega=False,
  speculative_k=...)`` with one prefix hit: streams, records and history
  exactly, the pool rows within 1e-4; a verify split over launch groups
  equal to one launch;
- lossless: every spec engine emits its own non-spec stream;
- the contracts: the options' checks, the window check, a poisoned slot
  evicted alone, deadline eviction, ``warmup``, ``dispatch_cost`` and
  ``dispatch_fn_args`` on the speculative program."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import decode_engine as jax_de
from paddle_tpu.inference.decode_engine import DecodeEngine as JaxEngine
from paddle_tpu.inference.paged_engine import (
    PagedDecodeEngine as JaxPagedEngine)
from paddle_tpu.models import gpt as jax_gpt
from paddle_tpu.quantization import quantize_tensor as jax_quantize
from paddle_tpu_torch import stats
from paddle_tpu_torch.inference import decode_engine as de
from paddle_tpu_torch.inference.decode_engine import DecodeEngine
from paddle_tpu_torch.inference.factory import make_engine
from paddle_tpu_torch.inference.paged_engine import PagedDecodeEngine
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.models.convert import gpt_from_jax_state
from paddle_tpu_torch.observability import devprof
from paddle_tpu_torch.ops import decode_megakernel as mk
from paddle_tpu_torch.testing import faults
from torch_reference_compile import fast_reference_compiles  # noqa: F401

# fp32 caches and pools: the same K/V rows up to summation order
ATOL = RTOL = 1e-4
PAGE = 128
WEIGHT_STD = 0.5
FIELDS = dict(vocab_size=96, max_seq_len=256, d_model=32, n_layers=2,
              n_heads=4)
N_NEW = 14


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    faults.clear()
    yield
    faults.clear()


def _state(jmodel, seed=0):
    rs = np.random.RandomState(seed)
    state = {}
    for k, v in sorted(jmodel.state_dict().items()):
        noise = rs.randn(*v.shape).astype(np.float32)
        state[k] = (1.0 + 0.1 * noise) if "scale" in k else (
            WEIGHT_STD * noise)
    return state


def _grid_state(jmodel):
    """Matmul weights snapped to the int8 grid, so the int8 copy holds
    them exactly."""
    state = _state(jmodel)
    for k, v in state.items():
        if k.split(".")[-1] in ("wqkv", "wo", "wup", "wdown"):
            state[k] = np.asarray(jax_quantize(
                jnp.asarray(v), axis=-1).dequantize())
    return state


def _models(state_fn=_state):
    jmodel = jax_gpt.GPT(jax_gpt.GPTConfig(dtype=jnp.float32, **FIELDS),
                         seed=0)
    state = state_fn(jmodel)
    jmodel.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    model = gpt_from_jax_state(gpt.GPTConfig(dtype=torch.float32, **FIELDS),
                               state, device="cpu")
    return jmodel, model


@pytest.fixture(scope="module")
def models():
    return _models()


def _prompts(kind, seed=1):
    """Four prompts: ``repeat`` loops a 6-token pattern (the regime the
    prompt-lookup drafts serve), ``random`` draws every token; the third
    is longer than the 32 bucket."""
    rs = np.random.RandomState(seed)
    sizes = (5, 13, 40, 9)
    if kind == "random":
        return [rs.randint(0, 96, size=n).tolist() for n in sizes]
    loops = [rs.randint(0, 96, size=6).tolist() for _ in sizes]
    return [(lp * 10)[:n] for lp, n in zip(loops, sizes)]


# JAX runs (and engine pairs) shared by the parametrized cases that
# compare against the same JAX engine: compiling one takes seconds
_JAX_RUNS = {}


def _jax_run(key, run):
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = run()
    return _JAX_RUNS[key]


def _record(eng):
    """Keep a copy of every speculative record the engine harvests."""
    out = []
    replay = eng._replay_spec

    def keep(rec, arr):
        out.append(np.array(arr))
        return replay(rec, arr)

    eng._replay_spec = keep
    return out


def _serve(eng, prompts, n_new=N_NEW, eos=None):
    """Two requests up front, two more after two steps (staggered)."""
    eos = eos or [None] * len(prompts)
    reqs = [eng.submit(p, n_new, eos_id=e)
            for p, e in zip(prompts[:2], eos[:2])]
    eng.step()
    eng.step()
    reqs += [eng.submit(p, n_new, eos_id=e)
             for p, e in zip(prompts[2:], eos[2:])]
    eng.run()
    return reqs


def _tokens(reqs):
    return [[int(t) for t in r.tokens] for r in reqs]


def _history_equal(eng, jeng):
    """Each slot's history rows [0, lengths] equal JAX's (engines or
    their ``_snapshot``s)."""
    lens = np.asarray(eng.lengths).tolist()
    assert lens == np.asarray(jeng.lengths).tolist()
    toks, jtoks = np.asarray(eng.toks), np.asarray(jeng.toks)
    for s, n in enumerate(lens):
        np.testing.assert_array_equal(toks[s, :n + 1], jtoks[s, :n + 1])


def _mid_run_eos(records, K, slot, stream):
    """A token that the request served from ``slot`` (``stream``, its
    tokens; ``records``, the engine's) emitted inside a run of two or
    more, before the run's end, and nowhere earlier in its stream: with
    it as eos, the verify that emits it must cut its run."""
    seen, used = list(stream[:1]), 0
    for arr in records:
        for j in range(arr.shape[0]):
            if used >= len(stream) - 1:
                return None
            n = int(arr[j, slot, K])
            run = [int(t) for t in arr[j, slot, :n]]
            used += n
            for t in run[:-1]:
                if t not in seen:
                    return t
            seen += run
    return None


# -- the shared helpers, against JAX -----------------------------------------

def _helper_inputs(seed, K, S=6, T=48, vocab=4):
    """int32 histories over a small vocabulary (bigram matches are
    common), lengths from 0 to T - 1 (an empty and a full history), and
    the acceptance inputs: predictions, accepted counts, non-finite and
    active flags, budgets from 0 to K + 1, eos ids (-1: none) drawn from
    the vocabulary, so an eos often sits inside the accepted run."""
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, vocab, size=(S, T)).astype(np.int32)
    lengths = rs.randint(0, T, size=S).astype(np.int32)
    lengths[0], lengths[1] = 0, T - 1
    last = rs.randint(0, vocab, size=S).astype(np.int32)
    pred = rs.randint(0, vocab, size=(S, K)).astype(np.int32)
    n_acc = rs.randint(0, K, size=S).astype(np.int32)
    bad = rs.rand(S) < 0.25
    active = rs.rand(S) < 0.75
    remaining = rs.randint(0, K + 2, size=S).astype(np.int32)
    eos = rs.randint(-1, vocab, size=S).astype(np.int32)
    return dict(toks=toks, lengths=lengths, last=last, pred=pred,
                n_acc=n_acc, bad=bad, active=active, remaining=remaining,
                eos=eos)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("K", [2, 3, 4, 8])
def test_prompt_lookup_draft_equals_jax(K, seed):
    a = _helper_inputs(seed, K)
    want = np.asarray(jax_de.prompt_lookup_draft(
        jnp.asarray(a["toks"]), jnp.asarray(a["lengths"]),
        jnp.asarray(a["last"]), K))
    got = de.prompt_lookup_draft(torch.from_numpy(a["toks"]),
                                 torch.from_numpy(a["lengths"]),
                                 torch.from_numpy(a["last"]), K)
    assert got.dtype == torch.int32 and got.shape == (6, K)
    np.testing.assert_array_equal(got.numpy(), want)
    # some slot found a match (nonzero drafts) and cand[:, 0] is last
    assert (got.numpy()[:, 1:] != 0).any()
    np.testing.assert_array_equal(got.numpy()[:, 0], a["last"])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("K", [2, 3, 4, 8])
def test_spec_accept_equals_jax(K, seed):
    a = _helper_inputs(seed, K)
    names = ("pred", "n_acc", "bad", "active", "remaining", "eos", "last")
    want = jax_de.spec_accept(*(jnp.asarray(a[n]) for n in names))
    got = de.spec_accept(*(torch.from_numpy(a[n]) for n in names))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    n_eff = got[0].numpy()
    assert got[0].dtype == torch.int32
    assert (n_eff[~a["active"]] == 0).all()
    assert (n_eff <= np.maximum(a["remaining"], 0)).all()


@pytest.mark.parametrize("K", [2, 4])
def test_append_history_clamps_its_window_as_jax(K):
    """The history append writes K predictions at lengths + 1, its
    window clamped to T - K; an inactive slot keeps its row."""
    rs = np.random.RandomState(K)
    T = 16
    toks = rs.randint(0, 9, size=(3, T)).astype(np.int32)
    lengths = np.array([2, T - 2, 5], np.int32)
    pred = rs.randint(0, 9, size=(3, K)).astype(np.int32)
    active = np.array([True, True, False])
    got = torch.from_numpy(toks.copy())
    de.append_history(got, torch.from_numpy(lengths),
                      torch.from_numpy(pred), torch.from_numpy(active))
    want = toks.copy()
    for s in range(2):
        start = min(lengths[s] + 1, T - K)
        want[s, start:start + K] = pred[s]
    np.testing.assert_array_equal(got.numpy(), want)


# -- the contiguous engine ----------------------------------------------------

@pytest.mark.parametrize("prompts", ["repeat", "random"])
@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("K", [2, 4])
def test_contiguous_engine_matches_jax(models, K, chunk, prompts):
    """Staggered admissions into 2 slots (the 40-token prompt chunked
    over buckets 16 and 32), one request with an eos: the streams, every
    packed record, the history and the caches equal JAX's."""
    jmodel, model = models
    ps = _prompts(prompts)
    kw = dict(max_slots=2, buckets=(16, 32), steps_per_call=chunk,
              speculative_k=K)
    free = _serve(DecodeEngine(model, device="cpu", **kw), ps)
    eos = [None, free[1].tokens[5], None, None]
    # one engine pair per (K, chunk), serving both prompt sets in turn
    # (a JAX engine compiles once): both hold the same history
    jeng, eng = _jax_run(("contiguous", K, chunk), lambda: (
        JaxEngine(jmodel, **kw), DecodeEngine(model, device="cpu", **kw)))
    steps0 = eng.steps
    jrecs, precs = _record(jeng), _record(eng)
    jreqs = _serve(jeng, ps, eos=eos)
    reqs = _serve(eng, ps, eos=eos)
    for e in (jeng, eng):          # the pair's next case records anew
        del e._replay_spec
    assert _tokens(reqs) == _tokens(jreqs)
    assert all(r.done and not r.failed for r in reqs)
    assert reqs[1].tokens[-1] == eos[1] and len(reqs[1].tokens) <= 6
    n = eng.steps - steps0
    assert len(precs) == len(jrecs) == n == jeng.steps - steps0
    for got, want in zip(precs, jrecs):
        assert got.shape == (chunk, 2, K + 2)
        np.testing.assert_array_equal(got, want)
    _history_equal(eng, jeng)
    np.testing.assert_allclose(eng.kc.numpy(), np.asarray(jeng.kc),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(eng.vc.numpy(), np.asarray(jeng.vc),
                               atol=ATOL, rtol=RTOL)
    # drafts were accepted: some verify emitted more than one token
    assert max(int(a[..., K].max()) for a in precs) >= 2


def _successor_drafts(streams, monkeypatch):
    """Replace the prompt-lookup drafts, in both packages, by a
    successor table of ``streams`` (each token's next token in them):
    drafts of a greedy stream then run long, so an eos can fall inside
    an accepted run. Prompt-lookup drafts come from the history, and
    with random weights the accepted ones are tokens the stream already
    emitted, never a first occurrence."""
    table = np.zeros((FIELDS["vocab_size"],), np.int32)
    for st in streams:
        for a, b in zip(st, st[1:]):
            table[a] = b
    jt, pt = jnp.asarray(table), torch.from_numpy(table)

    def jax_draft(toks, lengths, last, K):
        cand = [last]
        for _ in range(K - 1):
            cand.append(jt[cand[-1]])
        return jnp.stack(cand, axis=1)

    def port_draft(toks, lengths, last, K):
        cand = [last]
        for _ in range(K - 1):
            cand.append(pt[cand[-1].long()])
        return torch.stack(cand, dim=1)

    import paddle_tpu.inference.paged_engine as jax_pe
    monkeypatch.setattr(jax_de, "prompt_lookup_draft", jax_draft)
    monkeypatch.setattr(jax_pe, "prompt_lookup_draft", jax_draft)
    # the port's engines share one chunk loop (``_spec_chunk``)
    monkeypatch.setattr(de, "prompt_lookup_draft", port_draft)


@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("kind", ["contiguous", "paged", "paged_mega"])
def test_eos_inside_an_accepted_run_matches_jax(models, kind, K,
                                                monkeypatch):
    """With drafts that run long, request 1's eos is a token the free run
    emitted inside an accepted run: the verify that emits it cuts its
    run there, in both packages alike (streams and records)."""
    jmodel, model = models
    ps = _prompts("random", seed=9)[:2]

    def engines():
        if kind == "contiguous":
            kw = dict(max_slots=2, max_len=64, buckets=(16, 32),
                      steps_per_call=2, speculative_k=K)
            return (JaxEngine(jmodel, **kw),
                    DecodeEngine(model, device="cpu", **kw))
        kw = dict(n_pages=6, max_slots=2, steps_per_call=2,
                  speculative_k=K)
        return (JaxPagedEngine(jmodel, mega=False, **kw),
                PagedDecodeEngine(model, mega=kind == "paged_mega",
                                  device="cpu", **kw))

    plain = DecodeEngine(model, max_slots=2, max_len=64, device="cpu")
    preqs = [plain.submit(p, max_new_tokens=N_NEW) for p in ps]
    plain.run()
    streams = _tokens(preqs)
    _successor_drafts(streams, monkeypatch)
    free = engines()[1]
    recs = _record(free)
    reqs = [free.submit(p, max_new_tokens=N_NEW) for p in ps]
    free.run()
    assert _tokens(reqs) == streams              # still lossless
    eos = _mid_run_eos(recs, K, 1, reqs[1].tokens)
    assert eos is not None
    def serve(eng):
        recs = _record(eng)
        reqs = [eng.submit(p, max_new_tokens=N_NEW, eos_id=e)
                for p, e in zip(ps, (None, eos))]
        eng.run()
        return reqs, recs

    # the JAX engine is the same for paged and paged_mega
    jreqs, jrecs = _jax_run(("eos", kind == "contiguous", K, eos),
                            lambda: serve(engines()[0]))
    reqs, precs = serve(engines()[1])
    assert _tokens(reqs) == _tokens(jreqs)
    assert reqs[1].tokens == streams[1][:streams[1].index(eos) + 1]
    assert reqs[0].tokens == streams[0]
    for got, want in zip(precs, jrecs):
        np.testing.assert_array_equal(got, want)
    assert len(precs) == len(jrecs)


def test_int8_contiguous_engine_matches_jax_int8():
    """The int8 spec engine (the block products through K12's plain
    version, at M = S·K in the verify) on a grid-snapped model emits JAX
    int8 spec's streams, which equal the port's float engine's."""
    jmodel, model = _models(_grid_state)
    ps = _prompts("repeat", seed=4)
    kw = dict(max_slots=2, max_len=128, buckets=(16, 32),
              steps_per_call=2, speculative_k=3)
    streams = {}
    for name, make, mod, extra in (
            ("jax", JaxEngine, jmodel, {}),
            ("port", DecodeEngine, model, dict(device="cpu"))):
        fp = make(mod, **kw, **extra)
        q8 = make(None, share_weights_with=fp, weight_dtype="int8", **kw,
                  **extra)
        streams[name] = _tokens(_serve(q8, ps))
        if name == "port":
            assert _tokens(_serve(fp, ps)) == streams[name]
    assert streams["port"] == streams["jax"]


# -- the paged engine ---------------------------------------------------------

def _paged_prompts():
    """Loops, one over a full page, and a fourth sharing the third's
    first page: a page-aligned prefix hit (suffix prefill)."""
    rs = np.random.RandomState(2)
    loops = [rs.randint(0, 96, size=6).tolist() for _ in range(3)]
    ps = [(lp * 40)[:n] for lp, n in zip(loops, (5, 23, 170))]
    ps.append(ps[2][:PAGE] + rs.randint(0, 96, size=9).tolist())
    return ps


def _mapped_rows(eng, pool):
    """{(slot, layer, position): row} for the rows [0, length) each live
    slot's table maps."""
    out = {}
    for s, req in enumerate(eng._slot_req):
        if req is None:
            continue
        tab = eng._tables[s]
        for t in range(int(eng._host_len[s])):
            for layer in range(eng.cfg.n_layers):
                out[s, layer, t] = pool[layer * eng.P + tab[t // PAGE], :,
                                        t % PAGE]
    return out


def _snapshot(eng):
    """What the comparisons read of a drained engine."""
    return types.SimpleNamespace(
        lengths=np.asarray(eng.lengths).copy(),
        toks=np.asarray(eng.toks).copy(), tables=[list(t) for t in
                                                  eng._tables],
        host_len=list(eng._host_len),
        rows=_mapped_rows(eng, np.asarray(eng.kp)),
        kp=np.asarray(eng.kp).copy(), vp=np.asarray(eng.vp).copy())


def _paged_run(eng, ps):
    """Serve ``ps`` through a paged engine: one step, drained (the
    mid-run snapshot), then to the end. Returns (mid snapshot, requests,
    records, end snapshot)."""
    recs = _record(eng)
    reqs = [eng.submit(p, max_new_tokens=N_NEW) for p in ps]
    eng.step()
    eng.drain()
    mid = _snapshot(eng)
    eng.run()
    return mid, reqs, recs, _snapshot(eng)


@pytest.mark.parametrize("K, chunk", [(2, 1), (4, 4)])
@pytest.mark.parametrize("mega", [True, False])
def test_paged_engine_matches_jax(models, mega, K, chunk):
    """Single-dispatch (K8 + K9's plain versions over the S·K flat rows)
    and per layer (K2' over S·K query rows) against JAX's per-layer
    speculative engine: tables, mapped pool rows mid-run, streams, every
    packed record, the history and every pool row but the scratch page;
    the fourth prompt took the suffix path."""
    jmodel, model = models
    ps = _paged_prompts()
    kw = dict(n_pages=14, max_slots=4, steps_per_call=chunk,
              speculative_k=K)
    jmid, jreqs, jrecs, jend = _jax_run(
        ("paged", K, chunk), lambda: _paged_run(
            JaxPagedEngine(jmodel, mega=False, **kw), ps))
    stats.reset()
    eng = PagedDecodeEngine(model, mega=mega, device="cpu", **kw)
    assert eng.mega is mega
    mid, reqs, precs, end = _paged_run(eng, ps)
    assert mid.tables == jmid.tables and mid.host_len == jmid.host_len
    assert mid.rows.keys() == jmid.rows.keys() and len(mid.rows) > 2 * 170
    for key in jmid.rows:
        np.testing.assert_allclose(mid.rows[key], jmid.rows[key],
                                   atol=ATOL, rtol=RTOL, err_msg=str(key))
    for snap, jsnap in ((mid, jmid), (end, jend)):
        _history_equal(snap, jsnap)
    assert _tokens(reqs) == _tokens(jreqs)
    assert all(len(r.tokens) == N_NEW and not r.failed for r in reqs)
    assert len(precs) == len(jrecs) == eng.steps
    for g, w in zip(precs, jrecs):
        np.testing.assert_array_equal(g, w)
    assert stats.get("serve/prefix_hit_tokens") == PAGE
    assert stats.get("serve/dispatches/prefill_suffix") == 1
    for pool, jpool in ((end.kp, jend.kp), (end.vp, jend.vp)):
        np.testing.assert_allclose(pool[:-1], jpool[:-1], atol=ATOL,
                                   rtol=RTOL)
    assert eng.free_pages + eng._prefix.cached_pages == 14
    assert max(int(a[..., K].max()) for a in precs) >= 2


def test_split_mega_verify_equals_one_launch(models, monkeypatch):
    """With the megakernel's row cap at 4 and K 2, a verify of 4 slots
    (8 rows) runs as two K8 + K9 groups of 2 whole slots; with K 5, past
    the cap, each slot's rows run in order over two launches. The
    streams and pools equal the one-launch engine's."""
    _, model = models
    ps = _prompts("repeat", seed=6)
    kw = dict(n_pages=10, max_slots=4, steps_per_call=2, speculative_k=2,
              mega=True, device="cpu")
    one = PagedDecodeEngine(model, **kw)
    r_one = [one.submit(p, max_new_tokens=N_NEW) for p in ps]
    one.run()
    monkeypatch.setattr(mk, "MAX_ROWS", 4)
    split = PagedDecodeEngine(model, **kw)
    calls = []
    rows = split._mega_rows

    def counted(table, pos, *args):
        calls.append(pos.shape[0])
        return rows(table, pos, *args)

    split._mega_rows = counted
    r_split = [split.submit(p, max_new_tokens=N_NEW) for p in ps]
    split.run()
    assert _tokens(r_split) == _tokens(r_one)
    assert calls and set(calls) == {4}
    assert len(calls) == 2 * split.steps * split.chunk
    for a, b in ((split.kp, one.kp), (split.vp, one.vp)):
        np.testing.assert_allclose(a.numpy()[:-1], b.numpy()[:-1],
                                   atol=ATOL, rtol=RTOL)
    # a K past the cap: rows 0-3 of a slot in one launch, row 4 (which
    # attends to them through the pool) in the next
    kw = dict(n_pages=4, max_slots=1, steps_per_call=1, speculative_k=5,
              mega=True, device="cpu")
    monkeypatch.setattr(mk, "MAX_ROWS", 64)
    one = PagedDecodeEngine(model, **kw)
    r_one = one.submit(ps[0], max_new_tokens=N_NEW)
    one.run()
    monkeypatch.setattr(mk, "MAX_ROWS", 4)
    split = PagedDecodeEngine(model, **kw)
    calls.clear()
    rows = split._mega_rows
    split._mega_rows = counted
    r_split = split.submit(ps[0], max_new_tokens=N_NEW)
    split.run()
    assert _tokens([r_split]) == _tokens([r_one])
    assert calls == [4, 1] * split.steps
    for a, b in ((split.kp, one.kp), (split.vp, one.vp)):
        np.testing.assert_allclose(a.numpy()[:-1], b.numpy()[:-1],
                                   atol=ATOL, rtol=RTOL)


# -- lossless -----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["contiguous", "int8", "paged",
                                  "paged_mega"])
def test_spec_streams_equal_non_spec_streams(models, kind):
    """Greedy speculative decoding keeps the verify pass's own greedy
    stream: each engine's spec streams equal its non-spec streams."""
    jmodel, model = (_models(_grid_state) if kind == "int8" else models)
    ps = _prompts("repeat", seed=3) + _prompts("random", seed=5)[:2]
    streams = []
    for K in (0, 3):
        if kind in ("contiguous", "int8"):
            eng = DecodeEngine(model, max_slots=3, max_len=128,
                               buckets=(16, 32), steps_per_call=2,
                               speculative_k=K, device="cpu",
                               weight_dtype="int8" if kind == "int8"
                               else None)
        else:
            eng = PagedDecodeEngine(model, n_pages=12, max_slots=3,
                                    steps_per_call=2, speculative_k=K,
                                    mega=kind == "paged_mega",
                                    device="cpu")
        reqs = [eng.submit(p, max_new_tokens=N_NEW) for p in ps]
        eng.run()
        streams.append(_tokens(reqs))
        if K:
            assert stats.get("serve/dispatches/spec") > 0
    assert streams[0] == streams[1]
    assert all(len(set(t)) > 1 for t in streams[1])


# -- contracts ----------------------------------------------------------------

@pytest.mark.parametrize("engine, kwargs, err, match", [
    ("contiguous", dict(speculative_k=1), ValueError,
     "speculative_k must be >= 2"),
    ("paged", dict(speculative_k=1), ValueError,
     "speculative_k must be >= 2"),
    ("contiguous", dict(speculative_k=3, temperature=0.7),
     NotImplementedError, "greedy-only"),
])
def test_spec_options_raise(models, engine, kwargs, err, match):
    _, model = models
    with pytest.raises(err, match=match):
        make_engine(model, engine=engine, device="cpu", **kwargs)


@pytest.mark.parametrize("engine", ["contiguous", "paged"])
def test_spec_window_check(models, engine):
    """prompt + new + K - 1 must fit the cache (contiguous) or the
    position table (paged), as in JAX; without speculation it fits."""
    jmodel, model = models
    if engine == "contiguous":
        kw = dict(max_slots=1, max_len=128)
        eng = DecodeEngine(model, speculative_k=4, device="cpu", **kw)
        jeng = JaxEngine(jmodel, speculative_k=4, **kw)
        plain = DecodeEngine(model, device="cpu", **kw)
        n, new = 100, 26
    else:
        kw = dict(n_pages=4, max_slots=1)
        eng = PagedDecodeEngine(model, speculative_k=4, device="cpu", **kw)
        jeng = JaxPagedEngine(jmodel, speculative_k=4, mega=False, **kw)
        plain = PagedDecodeEngine(model, device="cpu", **kw)
        n, new = 100, 154
    plain.check_request(n, new)
    for e in (eng, jeng):
        e.check_request(n, new - 3)
        with pytest.raises(ValueError, match="speculative window"):
            e.check_request(n, new)


@pytest.mark.parametrize("kind", ["contiguous", "paged", "paged_mega"])
def test_poisoned_slot_evicted_alone(models, kind):
    """A slot poisoned for one dispatch fails with "non-finite logits";
    its peer keeps the stream of a clean run, and a paged engine's pages
    all come back."""
    _, model = models
    ps = _prompts("repeat", seed=7)[:2]

    def make():
        if kind == "contiguous":
            return DecodeEngine(model, max_slots=2, max_len=64,
                                steps_per_call=2, speculative_k=3,
                                device="cpu")
        return PagedDecodeEngine(model, n_pages=6, max_slots=2,
                                 steps_per_call=2, speculative_k=3,
                                 mega=kind == "paged_mega", device="cpu")

    clean = make()
    want = [clean.submit(p, max_new_tokens=10) for p in ps]
    clean.run()
    eng = make()
    stats.reset("serve/")
    reqs = [eng.submit(p, max_new_tokens=10) for p in ps]
    with faults.inject("engine.poison_logits", "nan", slot=1, after=1,
                       count=1):
        eng.run()
    assert reqs[1].failed and reqs[1].error == "non-finite logits"
    assert stats.get("serve/nonfinite_evictions") == 1
    assert not reqs[0].failed and reqs[0].tokens == want[0].tokens
    assert reqs[1].tokens == want[1].tokens[:len(reqs[1].tokens)]
    if kind != "contiguous":
        assert eng.free_pages + eng._prefix.cached_pages == 6


@pytest.mark.parametrize("kind", ["contiguous", "paged"])
def test_deadline_eviction(models, kind):
    _, model = models
    if kind == "contiguous":
        eng = DecodeEngine(model, max_slots=1, max_len=64, speculative_k=3,
                           device="cpu")
    else:
        eng = PagedDecodeEngine(model, n_pages=4, max_slots=1,
                                speculative_k=3, device="cpu")
    ps = _prompts("repeat")
    live = eng.submit(ps[0], max_new_tokens=6)
    queued = eng.submit(ps[1], max_new_tokens=6, deadline_s=-1.0)
    eng.run()
    assert len(live.tokens) == 6 and not live.failed
    assert queued.failed and "deadline" in queued.error
    eng2 = type(eng)(model, **(dict(max_slots=1, max_len=64)
                               if kind == "contiguous"
                               else dict(n_pages=4, max_slots=1)),
                     speculative_k=3, device="cpu")
    r = eng2.submit(ps[0], max_new_tokens=20, deadline_s=60.0)
    eng2.step()
    r.deadline = 0.0                       # expires mid-decode
    eng2.run()
    assert r.failed and r.error == "deadline exceeded"
    assert eng2.num_active == 0 if kind == "contiguous" else (
        eng2.free_pages + eng2._prefix.cached_pages == 4)


@pytest.mark.parametrize("kind", ["contiguous", "paged", "paged_mega"])
def test_warmup_and_dispatch_fn_args_on_the_spec_program(models, kind):
    """``warmup`` runs the speculative program on throwaway state (the
    streams are an unwarmed engine's, the history untouched);
    ``dispatch_fn_args`` is the speculative program, and one call of it
    on an engine with no live slot emits nothing."""
    _, model = models
    ps = _prompts("repeat", seed=8)[:2]

    def make(warm):
        if kind == "contiguous":
            return DecodeEngine(model, max_slots=2, max_len=64,
                                steps_per_call=2, speculative_k=3,
                                warmup=warm, device="cpu")
        return PagedDecodeEngine(model, n_pages=6, max_slots=2,
                                 steps_per_call=2, speculative_k=3,
                                 mega=kind == "paged_mega", warmup=warm,
                                 device="cpu")

    streams = []
    for warm in (False, True):
        stats.reset("serve/")
        eng = make(warm)
        assert stats.get("serve/warmup_s") == int(warm)
        assert not eng.toks.any()
        reqs = [eng.submit(p, max_new_tokens=8) for p in ps]
        eng.run()
        streams.append(_tokens(reqs))
    assert streams[0] == streams[1]
    fn, args = eng.dispatch_fn_args()
    assert fn.__name__ in ("_spec_multi_impl", "_spec_multi")
    toks0 = eng.toks.clone()
    assert devprof.count_kernel_launches(fn, *args) == 0      # CPU
    packed = fn(*args)[-1]
    assert tuple(packed.shape) == (eng.chunk, eng.S, 3 + 2)
    assert not packed[..., 3].any()          # no live slot emits
    assert torch.equal(eng.toks, toks0)      # inactive rows kept
    r = eng.submit(ps[0], max_new_tokens=5)
    eng.run()
    assert r.tokens == streams[0][0][:5]


def test_contiguous_dispatch_cost_is_a_hand_count(models):
    """Per verify: the four products and the LM head at S·K rows, the
    grouped einsum reading each slot's whole cache (T keys) for its K
    query rows, the fresh K and V rows written; chunk verifies."""
    _, model = models
    S, K, T, chunk = 2, 3, 128, 2
    eng = DecodeEngine(model, max_slots=S, max_len=T, steps_per_call=chunk,
                       speculative_k=K, device="cpu")
    assert eng.T == T
    d, H, hd, V, L, e = 32, 4, 8, 96, 2, 4
    M = S * K
    flops = nbytes = 0
    for k, n in ((d, 3 * d), (d, d), (d, 4 * d), (4 * d, d)):
        flops += L * 2 * M * k * n
        nbytes += L * (k * n + M * k + M * n) * e
    flops += L * 4 * S * K * T * H * hd
    nbytes += L * (2 * S * T * H * hd * e + 2 * M * H * hd * e + S * 4
                   + 2 * M * H * hd * e)
    flops += 2 * M * d * V
    nbytes += (d * V + M * d + M * V) * e
    cap = eng.dispatch_cost()
    assert cap.name == "spec"
    assert (cap.flops, cap.hbm_bytes) == (chunk * flops, chunk * nbytes)
    assert cap.memory["output_size_in_bytes"] == (
        (K + 2) * chunk * S * 4 + 4 * S * 4)


@pytest.mark.parametrize("mega", [True, False])
def test_paged_dispatch_cost_is_a_hand_count(models, mega):
    """Per verify, row j of a slot at its length + j (each slot advanced
    one a verify): single-dispatch, K8's and K9's costs over the S·K
    rows; per layer, the products at S·K rows, K2' over the rows and the
    fresh K and V rows written, and the LM head."""
    from paddle_tpu_torch.ops.paged_attention import (
        paged_decode_attention_cost)
    _, model = models
    S, K, chunk = 2, 3, 2
    eng = PagedDecodeEngine(model, n_pages=6, max_slots=S,
                            steps_per_call=chunk, speculative_k=K,
                            mega=mega, device="cpu")
    eng.submit([1, 2, 3, 4, 5], max_new_tokens=20)
    eng.step()
    eng.drain()
    lens, act = eng.lengths.tolist(), eng.active.tolist()
    assert act.count(True) == 1
    d, H, hd, V, e = 32, 4, 8, 96, 4
    flops = nbytes = 0
    for j in range(chunk):
        pos = [n + j * a for n, a in zip(lens, act)]
        keys = [p + i + 1 for p in pos for i in range(K)]
        if mega:
            f, b = mk.mega_decode_layers_cost(keys, eng._stacked, H, H, hd,
                                              e)
            f2, b2 = mk.mega_logits_sample_cost(S * K, d, V, e)
            f, b = f + f2, b + b2
        else:
            fa, ba = paged_decode_attention_cost(keys, H, H, hd, e)
            f = b = 0
            for w in eng._layers:
                fm, bm = de.block_matmul_cost(w, S * K, e)
                f += fm + fa
                b += bm + ba + 2 * S * K * H * hd * e
            f += 2 * S * K * d * V
            b += (d * V + S * K * d + S * K * V) * e
        flops += f
        nbytes += b
    cap = eng.dispatch_cost()
    assert cap.name == "paged_spec"
    assert (cap.flops, cap.hbm_bytes) == (flops, nbytes)
    eng.run()
