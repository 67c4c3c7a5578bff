"""The port's observability copies against the JAX package's modules, on
the same inputs drawn from numpy seeds: ``comm``'s interval algebra,
``trace``'s spans and Chrome export, ``flight``'s per-request ring and
dump, ``testing.faults``' rule schedules (``slot_mask``, ``fire``,
``transform``, ``PT_FAULTS``), ``stats``' export/merge/table,
``statsz``'s Prometheus text and live endpoint, and ``merge``'s
merge/stitch/``request_segments``. Each test resets the global trace
ring, stats registries and fault rules of both packages."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu import stats as jstats
from paddle_tpu.observability import comm as jcomm
from paddle_tpu.observability import flight as jflight
from paddle_tpu.observability import merge as jmerge
from paddle_tpu.observability import statsz as jstatsz
from paddle_tpu.observability import trace as jtrace
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch import stats
from paddle_tpu_torch.observability import comm, flight, merge, statsz, trace
from paddle_tpu_torch.testing import faults

SEEDS = (0, 1, 2, 3)


@pytest.fixture(autouse=True)
def _clean():
    for mod in (trace, jtrace):
        mod.disable()
        mod.clear()
    for mod in (faults, jfaults):
        mod.clear()
    for mod in (stats, jstats):
        mod.reset()
    yield
    for mod in (trace, jtrace):
        mod.disable()
        mod.clear()
    for mod in (faults, jfaults):
        mod.clear()
    for mod in (stats, jstats):
        mod.reset()


def _intervals(rs, n):
    a = rs.uniform(0, 10, size=n)
    return [(float(x), float(x + d)) for x, d in
            zip(a, rs.uniform(-0.5, 3, size=n))]


# -- comm: the interval algebra ---------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_exposed_time_and_overlap_equal_jax(seed):
    rs = np.random.RandomState(seed)
    c, k = _intervals(rs, 12), _intervals(rs, 9)
    assert comm._union(c) == jcomm._union(c)
    assert comm.exposed_time(c, k) == jcomm.exposed_time(c, k)
    assert comm.overlap_fraction(c, k) == jcomm.overlap_fraction(c, k)


@pytest.mark.parametrize("seed", SEEDS)
def test_span_intervals_and_step_overlap_equal_jax(seed):
    rs = np.random.RandomState(seed)
    names = ["collective/ar", "compute/step", "serve/dispatch", "other"]
    evs = [(names[rs.randint(4)], int(rs.randint(0, 10**9)),
            int(rs.randint(0, 10**8))) for _ in range(40)]
    window = (0.2, 0.8) if seed % 2 else None
    for prefix in ("collective/", "compute/", "serve/"):
        assert (comm.span_intervals(evs, prefix, window)
                == jcomm.span_intervals(evs, prefix, window))
    assert comm.step_overlap(evs, window=window) == jcomm.step_overlap(
        evs, window=window)
    assert (comm.record_step_overlap(evs)
            == jcomm.record_step_overlap(evs))
    assert stats.get("comm/overlap_frac") == jstats.get("comm/overlap_frac")


# -- trace: spans and export --------------------------------------------------

def _drive(tr):
    """The same span program through either package's tracer."""
    tr.enable()
    with tr.span("outer", kind="a") as sp:
        with tr.span("inner", n=1):
            pass
        sp.attrs["late"] = 7
    tok = tr.begin("async", rid="r1")
    tr.end(tok, tokens=3)
    tr.complete("after", 1.0, 2.5, rid="r2")
    tr.instant("mark", x=1)

    @tr.span("decorated", d=2)
    def f():
        with tr.span("nested"):
            return 1
    f()
    tr.disable()
    with tr.span("dropped"):
        pass
    evs, dropped = tr.events()
    return evs, dropped


def test_span_program_records_the_same_events():
    got, gd = _drive(trace)
    ref, rd = _drive(jtrace)
    assert gd == rd == 0
    # (name, attrs, has a parent) without clocks, ids and thread ids
    key = [(e[0], e[6], e[5] != 0) for e in got]
    assert key == [(e[0], e[6], e[5] != 0) for e in ref]
    # the parent of "inner" is "outer"; of "nested", "decorated"
    by_name = {e[0]: e for e in got}
    assert by_name["inner"][5] == by_name["outer"][4]
    assert by_name["nested"][5] == by_name["decorated"][4]


def test_ring_overflow_keeps_newest_and_counts_dropped(tmp_path):
    for tr, st in ((trace, stats), (jtrace, jstats)):
        tr.enable(capacity=4)
        for i in range(10):
            with tr.span(f"s{i}"):
                pass
        evs, dropped = tr.events()
        assert [e[0] for e in evs] == [f"s{i}" for i in range(6, 10)]
        assert dropped == 6
        tr.export(str(tmp_path / f"{tr.__name__}.json"))
        assert st.get("trace/dropped") == 6
        tr.disable()
        tr.clear(capacity=65536)


def test_chrome_export_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PT_PROCESS_ID", "3")
    docs = []
    for tr in (trace, jtrace):
        _drive(tr)
        out_dir = tmp_path / tr.__name__.replace(".", "_")
        out_dir.mkdir()
        path = tr.export(str(out_dir))
        with open(path) as f:
            docs.append(json.load(f))
        assert path.endswith("trace_rank3.json")

    def shape(doc):
        out = []
        for e in doc["traceEvents"]:
            args = {k: v for k, v in e.get("args", {}).items()
                    if k not in ("span_id", "parent_id")}
            out.append((e["name"], e["ph"], e["pid"], e.get("cat"),
                        json.dumps(args, sort_keys=True)))
        return out

    assert shape(docs[0]) == shape(docs[1])
    assert docs[0]["otherData"] == docs[1]["otherData"]


def test_trace_file_from_env_equal_jax(monkeypatch, tmp_path):
    for env in ({}, {"PT_TRACE_DIR": str(tmp_path)},
                {"PT_TRACE_DIR": str(tmp_path), "PT_PROCESS_ID": "2"},
                {"PT_TRACE_FILE": str(tmp_path / "x.json"),
                 "PT_TRACE_DIR": str(tmp_path)}):
        for k in ("PT_TRACE_DIR", "PT_TRACE_FILE", "PT_PROCESS_ID"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert trace.trace_file_from_env() == jtrace.trace_file_from_env()


def test_flush_interval_from_env_equal_jax(monkeypatch):
    for raw in (None, "", "2.5", "0", "-1", "junk"):
        if raw is None:
            monkeypatch.delenv("PT_TRACE_FLUSH_S", raising=False)
        else:
            monkeypatch.setenv("PT_TRACE_FLUSH_S", raw)
        assert (trace._flush_interval_from_env()
                == jtrace._flush_interval_from_env())


# -- flight recorder ----------------------------------------------------------

def _flight_program(rec, rs):
    rids = [f"r{i}" for i in range(6)]
    for _ in range(40):
        rid = rids[rs.randint(len(rids))]
        rec.record(rid, ["admit", "prefill-chunk", "evicted"][
            rs.randint(3)], slot=int(rs.randint(4)), tokens=int(
                rs.randint(9)))
    rec.record(None, "ignored")
    return rids


@pytest.mark.parametrize("seed", SEEDS)
def test_flight_ring_equal_jax(seed):
    got = flight.FlightRecorder(capacity=4, max_events=5)
    ref = jflight.FlightRecorder(capacity=4, max_events=5)
    rids = _flight_program(got, np.random.RandomState(seed))
    _flight_program(ref, np.random.RandomState(seed))
    assert got.dropped == ref.dropped

    def strip(evs):
        return [{k: v for k, v in e.items() if k != "t"} for e in evs]

    for rid in rids:
        assert strip(got.events(rid)) == strip(ref.events(rid))


def test_flight_dump_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PT_FLIGHT_DIR", str(tmp_path))
    recs = []
    for mod, st in ((flight, stats), (jflight, jstats)):
        r = mod.FlightRecorder(capacity=8)
        r.record("a/b", "admit", slot=1, prompt=5)
        r.record("a/b", "evicted", reason="non-finite logits", slot=1)
        rec = r.dump("a/b", "non-finite logits")
        assert st.get("serve/flight_dumps") == 1
        with open(rec["path"]) as f:
            on_disk = json.load(f)
        recs.append({k: v for k, v in on_disk.items()
                     if k not in ("dumped_at", "path")})
        assert r.dump("missing", "x") is None
    for rec in recs:
        for e in rec["events"]:
            e.pop("t")
    assert recs[0] == recs[1]


def test_flight_ring_env_and_disabled(monkeypatch):
    monkeypatch.setenv("PT_FLIGHT_RING", "0")
    for mod in (flight, jflight):
        r = mod.FlightRecorder()
        assert not r.enabled
        r.record("x", "admit")
        assert r.events("x") == []


# -- fault injection ----------------------------------------------------------

RULES = [
    dict(site="engine.poison_logits", action="nan", slot=1, after=1,
         count=2),
    dict(site="engine.poison_logits", action="nan", slots="0|3"),
    dict(site="engine.poison_logits", action="nan", after=4, count=1),
    dict(site="engine.poison_logits", action="delay", seconds=0.0),
]


@pytest.mark.parametrize("rule", RULES,
                         ids=[f"rule{i}" for i in range(len(RULES))])
def test_slot_mask_schedule_equal_jax(rule):
    kw = {k: v for k, v in rule.items() if k not in ("site", "action")}
    masks = []
    for mod in (faults, jfaults):
        with mod.inject(rule["site"], rule["action"], **kw) as r:
            masks.append([mod.slot_mask(rule["site"], 4).tolist()
                          for _ in range(7)])
            fired = r.fired
        masks[-1].append(fired)
        assert not mod.enabled()
    assert masks[0] == masks[1]


@pytest.mark.parametrize("spec", [
    "engine.poison_logits:nan:slot=1,after=1,count=1",
    "engine.poison_logits:nan:slots=0|2;store.get:drop:after=2",
    " ; engine.poison_logits:nan ;",
])
def test_pt_faults_env_equal_jax(spec, monkeypatch):
    monkeypatch.setenv("PT_FAULTS", spec)
    out = []
    for mod in (faults, jfaults):
        n = mod.install_from_env()
        out.append((n, [mod.slot_mask("engine.poison_logits", 3).tolist()
                        for _ in range(4)],
                    [mod.fire("store.get") for _ in range(4)]))
        mod.clear()
    assert out[0] == out[1]


def test_fire_transform_and_errors_equal_jax():
    payload = bytes(range(16))
    for mod in (faults, jfaults):
        with mod.inject("p", "bitflip", offset=3, bit=2):
            flipped = mod.transform("p", payload)
        with mod.inject("p", "truncate", keep=5):
            cut = mod.transform("p", payload)
        with mod.inject("p", "nan", n=2):
            arr = mod.transform("p", np.ones(4, np.float32))
        with mod.inject("p", "raise", exc="ConnectionError"):
            with pytest.raises(ConnectionError, match="injected"):
                mod.fire("p")
        with mod.inject("p", "drop", after=1):
            drops = [mod.fire("p") for _ in range(3)]
        with pytest.raises(ValueError, match="unknown fault action"):
            mod.install_rule("p", "explode")
        monkey = {"PT_FAULTS": "justasite"}
        with pytest.raises(ValueError, match="site:action"):
            mod.install_from_env(monkey)
        mod.clear()
        if mod is faults:
            got = (flipped, cut, np.isnan(arr).tolist(), drops)
        else:
            ref = (flipped, cut, np.isnan(arr).tolist(), drops)
    assert got == ref


# -- stats, statsz, Prometheus ------------------------------------------------

def _fill(reg, rs):
    for i in range(5):
        reg.add(f"serve/c{i % 2}", int(rs.randint(1, 9)))
    reg.set_value("serve/depth", float(rs.uniform()))
    for v in rs.lognormal(-5, 2, size=50):
        reg.observe("serve/ttft_s", float(v))
    reg.record_time("ckpt/save", 0.25)
    reg.record_time("ckpt/save", 0.5)


@pytest.mark.parametrize("seed", SEEDS)
def test_registry_export_snapshot_table_equal_jax(seed, monkeypatch):
    monkeypatch.setenv("PT_PROCESS_ID", "1")
    got, ref = stats.StatRegistry(), jstats.StatRegistry()
    _fill(got, np.random.RandomState(seed))
    _fill(ref, np.random.RandomState(seed))
    assert got.export() == ref.export()
    assert got.snapshot(tag_rank=True) == ref.snapshot(tag_rank=True)
    assert got.table("serve/") == ref.table("serve/")
    got.reset("ckpt/save.")
    ref.reset("ckpt/save.")
    assert got.snapshot() == ref.snapshot()
    exports = [got.export(rank=0), got.export(rank=1)]
    assert (stats.merge(exports).snapshot()
            == jstats.merge(exports).snapshot())


@pytest.mark.parametrize("seed", SEEDS)
def test_prometheus_text_equal_jax(seed):
    got, ref = stats.StatRegistry(), jstats.StatRegistry()
    _fill(got, np.random.RandomState(seed))
    _fill(ref, np.random.RandomState(seed))
    assert statsz.prometheus_text(got) == jstatsz.prometheus_text(ref)


def test_statsz_endpoint_serves_the_port_registry():
    stats.add("statsz/hits", 3)
    stats.observe("statsz/lat_s", 0.5)
    srv = statsz.StatszServer(0, host="127.0.0.1")
    try:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/statsz", timeout=5) as r:
            doc = json.load(r)
        assert doc == stats.export()
        with urllib.request.urlopen(base + "/statsz?flat=1",
                                    timeout=5) as r:
            assert json.load(r) == stats.snapshot()
        with urllib.request.urlopen(base + "/metricsz", timeout=5) as r:
            assert r.read().decode() == statsz.prometheus_text(
                stats.default_registry())
        with urllib.request.urlopen(base + "/", timeout=5) as r:
            assert "statsz/hits" in r.read().decode()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=5)
    finally:
        srv.stop()


def test_init_from_env_starts_statsz_only_when_asked(monkeypatch):
    from paddle_tpu_torch import observability
    monkeypatch.delenv("PT_STATSZ_PORT", raising=False)
    monkeypatch.delenv("PT_TRACE_DIR", raising=False)
    monkeypatch.delenv("PT_TRACE_FILE", raising=False)
    observability.init_from_env()
    assert statsz._server is None and not trace.enabled()
    monkeypatch.setenv("PT_STATSZ_PORT", "0")
    try:
        observability.init_from_env()
        assert statsz._server is not None and statsz._server.port > 0
    finally:
        statsz.stop_statsz()
    monkeypatch.setenv("PT_STATSZ_PORT", "not-a-port")
    observability.init_from_env()
    assert statsz._server is None


# -- merge and stitch ---------------------------------------------------------

def _rank_file(path, rank, rs, rids):
    evs = [{"name": "process_name", "ph": "M", "pid": rank, "tid": 0,
            "args": {"name": f"rank{rank}"}}]
    t = 0.0
    for rid in rids:
        for name in ("serve/queue", "serve/admit", "serve/decode",
                     "serve/request"):
            dur = float(rs.randint(1, 50))
            evs.append({"name": name, "ph": "X", "ts": t, "dur": dur,
                        "pid": rank, "tid": 1, "args": {"rid": rid}})
            t += float(rs.randint(1, 20))
    path.write_text(json.dumps({"traceEvents": evs}))
    return str(path)


@pytest.mark.parametrize("seed", SEEDS)
def test_merge_stitch_and_segments_equal_jax(seed, tmp_path):
    rs = np.random.RandomState(seed)
    paths = [_rank_file(tmp_path / f"trace_rank{r}.json", r, rs,
                        [f"q{r}{i}" for i in range(3)]) for r in range(2)]
    outs = []
    for mod, tag in ((merge, "port"), (jmerge, "jax")):
        m = mod.merge_trace_files(paths, str(tmp_path / f"m_{tag}.json"))
        st, summary = mod.stitch_trace_files(
            paths, str(tmp_path / f"s_{tag}.json"))
        with open(m) as f:
            merged = json.load(f)
        with open(st) as f:
            stitched = json.load(f)
        outs.append((merged, stitched, summary))
    assert outs[0] == outs[1]
    with open(paths[0]) as f:
        evs = json.load(f)["traceEvents"]
    assert merge.request_segments(evs) == jmerge.request_segments(evs)
    assert (merge.discover_trace_files(str(tmp_path))
            == jmerge.discover_trace_files(str(tmp_path)))
