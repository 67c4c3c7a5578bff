"""The port's numerics capture against the JAX package's, on the CPU.

- ``capture_step`` on the same gradients and updates (the port's flat
  dict, the JAX stacked state): the same layout (family names in the
  JAX leaf names, sizes) and the same packed vector, counts exactly and
  sums to 2e-5 relative (fp32 sums of 10^4 terms in another order);
- ``poison_grads`` through each package's fault site: the same element
  poisoned;
- the GPT train step with ``PT_NUMERICS_EVERY``: the same layout as the
  JAX stacked step and packed vectors within 1e-3 relative (the
  gradients agree to 1e-4), 1e-2 for the update families (Adam steps
  of about lr, some on noise-level gradients);
  a poisoned layer named alike, with and without the global-norm clip;
  parameters bit-identical with numerics off; off-cadence steps zeroed;
- the host plane (``Monitor``, ``NumericsWatch``, ``NumericsRecorder``)
  fires the same alerts as the JAX one on the same snapshots.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jax_optim
from paddle_tpu.models import gpt as jax_gpt
from paddle_tpu.observability import numerics as jax_nm
from paddle_tpu.testing import faults as jax_faults
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.models.convert import gpt_from_jax_state
from paddle_tpu_torch.observability import numerics as nm
from paddle_tpu_torch import optimizer as optim
from paddle_tpu_torch.testing import faults

from test_torch_gpt import JAX_CONFIGS, port_config, random_state
from test_torch_optim_suite import _tiny_params
from torch_reference_compile import fast_reference_compiles  # noqa: F401

STACKED = "_stacked_blocks"

COUNT_COLS = (2, 3, 4)     # nonfinite, overflow, underflow


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _to_jax(tree):
    """port names -> the JAX stacked state as its step sees it: the head
    entries by name and ``_stacked_blocks``, whose leaves (a block's
    parameters) flatten in sorted name order under paths ``<j>``; a list
    in that order has the same paths."""
    out = {n: jnp.asarray(v) for n, v in tree.items()
           if not n.startswith("stacked.")}
    out[STACKED] = [jnp.asarray(tree[n]) for n in sorted(tree)
                    if n.startswith("stacked.")]
    return out


def _from_jax(tree, names):
    slabs = sorted(n for n in names if n.startswith("stacked."))
    out = {n: np.asarray(v) for n, v in tree.items() if n != STACKED}
    out.update({n: np.asarray(v) for n, v in zip(slabs, tree[STACKED])})
    return out


def _slabs(tree):
    """The port's slab entries, as ``GPT.slab_entries`` names them."""
    return [n for n in tree if n.startswith("stacked.")]


def _assert_packed(got, want, layout, rtol, upd_rtol=None):
    """Entry by entry: the header exactly, count columns exactly, the
    sums and maxima to ``rtol`` (``upd_rtol`` for the update
    families)."""
    got = np.asarray(got.detach().cpu(), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape == (layout.size,)
    np.testing.assert_array_equal(got[[0, 2, 3, 4]], want[[0, 2, 3, 4]])
    np.testing.assert_allclose(got[1], want[1], rtol=rtol, equal_nan=True)
    off = nm.NHDR
    for name, L, _ in layout.families:
        g = got[off:off + L * nm.NCOL].reshape(L, nm.NCOL)
        w = want[off:off + L * nm.NCOL].reshape(L, nm.NCOL)
        off += L * nm.NCOL
        np.testing.assert_array_equal(g[:, COUNT_COLS], w[:, COUNT_COLS],
                                      err_msg=name)
        tol = upd_rtol if upd_rtol and name.startswith("upd/") else rtol
        np.testing.assert_allclose(g[:, :2], w[:, :2], rtol=tol,
                                   atol=1e-30, err_msg=name)


def _planted(raw):
    """Gradients with a NaN, an inf, a value near the fp32 max and a
    subnormal in layer 1 of two slabs and in the head."""
    g = {n: v.copy() for n, v in raw.items()}
    g["stacked.wqkv"][1, 3, 5] = np.nan
    g["stacked.wup"][1, 0, 0] = np.inf
    g["stacked.wup"][0, 1, 1] = 3.2e38
    g["stacked.ln2_bias"][1, 2] = 1e-40
    g["wte"][4, 4] = -np.inf
    return g


@pytest.mark.parametrize("planted", [False, True])
def test_capture_step_matches_jax(planted):
    raw = _tiny_params(0)
    grads = _planted(raw) if planted else raw
    upd = {n: 1e-3 * np.sign(v) for n, v in raw.items()}
    jbox, tbox = jax_nm.LayoutBox(), nm.LayoutBox()
    # jitted (op by op it takes several times longer); the layout is
    # recorded into the box while tracing
    want = jax.jit(lambda g, u: jax_nm.capture_step(
        g, loss=jnp.float32(2.5), updates=u, box=jbox))(_to_jax(grads),
                                                        _to_jax(upd))
    got = nm.capture_step({n: torch.from_numpy(v) for n, v in grads.items()},
                          loss=torch.tensor(2.5),
                          updates={n: torch.from_numpy(v)
                                   for n, v in upd.items()},
                          stacked_keys=_slabs(raw), box=tbox)
    assert tbox.layout.families == jbox.layout.families
    _assert_packed(got, want, tbox.layout, 2e-5)
    snap = tbox.layout.unpack(got)
    jsnap = jbox.layout.unpack(np.asarray(want))
    assert snap["first_bad_layer"] == jsnap["first_bad_layer"]
    assert snap["first_bad_family_name"] == jsnap["first_bad_family_name"]
    if planted:
        # the head's -inf pools into the one-row (rest) family: layer 0
        assert snap["first_bad_layer"] == 0
        assert snap["first_bad_family_name"] == "grad/(rest)"
        assert snap["nonfinite"] == 3


def test_leaf_raw_matches_jax():
    x = np.random.RandomState(1).randn(5, 7).astype(np.float32)
    x[0, 0] = 1e-41
    np.testing.assert_allclose(nm.leaf_raw(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_nm.leaf_raw(jnp.asarray(x))),
                               rtol=1e-6)


@pytest.mark.parametrize("rule", [
    dict(action="nan", layer=1, key="_stacked_blocks"),
    dict(action="nan", layer=0, key="_stacked_blocks.10"),
    dict(action="bitflip", layer=1, key="_stacked_blocks.3", bit=29),
    dict(action="nan", key="wte"),
])
def test_poison_grads_matches_jax(rule):
    raw = _tiny_params(4)
    rule = dict(rule)
    action = rule.pop("action")
    with jax_faults.inject(jax_nm.FAULT_SITE, action, **rule):
        want = jax_nm.poison_grads(_to_jax(raw))
    with faults.inject(nm.FAULT_SITE, action, **rule):
        got = nm.poison_grads({n: torch.from_numpy(v)
                               for n, v in raw.items()}, _slabs(raw))
    want = _from_jax(want, raw)
    changed = 0
    for n, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[n], err_msg=n)
        changed += int((v.numpy() != raw[n]).sum()
                       + np.isnan(v.numpy()).sum())
    assert changed >= 1
    # the given gradients are left as they were
    assert not any(np.isnan(v).any() for v in raw.values())


def _gpt_pair(monkeypatch, clip=False):
    monkeypatch.setenv("PT_NUMERICS_EVERY", "1")
    jcfg = JAX_CONFIGS["gpt_tiny"]
    jmodel = jax_gpt.GPT(jcfg, seed=0)
    state = random_state(jmodel, seed=1)
    jmodel.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    model = gpt_from_jax_state(port_config(jcfg), state, device="cpu")
    jopt = jax_optim.AdamW(
        learning_rate=1e-3,
        grad_clip=jax_optim.ClipGradByGlobalNorm(1.0) if clip else None)
    topt = optim.AdamW(
        learning_rate=1e-3,
        grad_clip=optim.ClipGradByGlobalNorm(1.0) if clip else None)
    tok = np.random.RandomState(2).randint(0, jcfg.vocab_size,
                                           size=(2, 16)).astype(np.int32)
    return jmodel, model, jopt, topt, tok


def _run_both(jmodel, model, jopt, topt, tok, steps=1):
    jparams, jstate = jax_gpt.init_train_state(jmodel, jopt, stacked=True)
    jstep = jax_gpt.build_train_step(jmodel, jopt, donate=False)
    params, state = gpt.init_train_state(model, topt)
    step = gpt.build_train_step(model, topt)
    out = []
    for _ in range(steps):
        jparams, jstate, _, jpacked = jstep(jparams, jstate,
                                            jnp.asarray(tok),
                                            jax.random.PRNGKey(0))
        params, state, _, packed = step(params, state,
                                        torch.from_numpy(tok))
        out.append((packed, jpacked))
    return step, jstep, out


def test_gpt_step_numerics_matches_jax(monkeypatch):
    jmodel, model, jopt, topt, tok = _gpt_pair(monkeypatch)
    step, jstep, out = _run_both(jmodel, model, jopt, topt, tok, steps=2)
    lay, jlay = step.numerics_layout.layout, jstep.numerics_layout.layout
    assert lay.families == jlay.families
    assert lay.size == jlay.size
    # L rows per stacked family: 2 layers of gpt_tiny, 12 slabs, grad
    # and upd
    assert sum(L == 2 for _, L, _ in lay.families) == 24
    # an update entry whose gradient is at the rounding noise (the key
    # bias's: its true gradient is 0) steps by about lr with a sign and
    # size that need not agree, so update sums agree to 1e-2
    for packed, jpacked in out:
        _assert_packed(packed, jpacked, lay, 1e-3, upd_rtol=1e-2)
    mon = nm.Monitor.for_step(step)
    snap = mon.ingest(out[-1][0], 1)
    assert snap["first_bad_layer"] == -1 and snap["alerts"] == []
    assert snap["update_rms"] is not None and math.isfinite(
        snap["grad_rms"])


@pytest.mark.parametrize("clip", [False, True])
def test_gpt_step_poisoned_layer_named_like_jax(monkeypatch, clip):
    """layer 1 of the first slab poisoned: without a clip both name
    layer 1; with the global-norm clip the NaN reaches every update
    (the norm is NaN), so both name layer 0's first update family."""
    jmodel, model, jopt, topt, tok = _gpt_pair(monkeypatch, clip)
    kw = dict(layer=1, key="_stacked_blocks")
    with jax_faults.inject(jax_nm.FAULT_SITE, "nan", **kw), \
            faults.inject(nm.FAULT_SITE, "nan", **kw):
        step, jstep, out = _run_both(jmodel, model, jopt, topt, tok)
    packed, jpacked = out[0]
    snap = nm.Monitor.for_step(step).ingest(packed, 0)
    jsnap = jax_nm.Monitor.for_step(jstep).ingest(jpacked, 0)
    for k in ("first_bad_layer", "first_bad_family_name", "nonfinite"):
        assert snap[k] == jsnap[k], k
    assert snap["first_bad_layer"] == (0 if clip else 1)
    assert snap["alerts"] == jsnap["alerts"] == ["nonfinite"]


def test_numerics_leaves_params_bit_identical(monkeypatch):
    outs = []
    for every in ("0", "1"):
        monkeypatch.setenv("PT_NUMERICS_EVERY", every)
        model = gpt.GPT(gpt.gpt_tiny(), seed=3, device="cpu")
        opt = optim.AdamW(learning_rate=1e-3)
        params, state = gpt.init_train_state(model, opt)
        step = gpt.build_train_step(model, opt)
        tok = torch.from_numpy(np.random.RandomState(5).randint(
            0, 256, size=(2, 16)).astype(np.int32))
        for _ in range(2):
            out = step(params, state, tok)
            params, state = out[0], out[1]
            assert len(out) == (4 if every == "1" else 3)
        outs.append({n: p.detach().clone() for n, p in params.items()})
    for n in outs[0]:
        assert torch.equal(outs[0][n], outs[1][n]), n


def test_off_cadence_steps_are_zeroed(monkeypatch):
    monkeypatch.setenv("PT_NUMERICS_EVERY", "2")
    model = gpt.GPT(gpt.gpt_tiny(), seed=3, device="cpu")
    opt = optim.AdamW(learning_rate=1e-3)
    params, state = gpt.init_train_state(model, opt)
    step = gpt.build_train_step(model, opt)
    mon = nm.Monitor.for_step(step)
    tok = torch.zeros((2, 16), dtype=torch.int32)
    snaps = []
    for i in range(4):
        params, state, _, packed = step(params, state, tok)
        assert packed.shape == (step.numerics_layout.layout.size,)
        assert (float(packed[0]) == 1.0) == (i % 2 == 0)
        snaps.append(mon.ingest(packed, i))
    assert [s is not None for s in snaps] == [True, False, True, False]
    assert mon.samples == 2


def _snap(loss, grad_rms=1.0, nonfinite=0.0, layer=-1, fam=None,
          over=0.0, step=0):
    return {"loss": loss, "grad_rms": grad_rms, "nonfinite": nonfinite,
            "first_bad_layer": layer, "first_bad_family_name": fam,
            "overflow_frac_max": over, "step": step}


def test_watch_fires_like_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PT_NUMERICS_DIR", str(tmp_path))
    seq = ([_snap(2.0 + 0.01 * (i % 3), step=i) for i in range(10)]
           + [_snap(50.0, step=10), _snap(60.0, step=11),
              _snap(2.0, step=12),
              _snap(2.0, nonfinite=3.0, layer=4, fam="grad/x", step=13),
              _snap(2.0, over=0.5, step=14)])
    rec, jrec = nm.NumericsRecorder(4), jax_nm.NumericsRecorder(4)
    w = nm.NumericsWatch(window=8, recorder=rec)
    jw = jax_nm.NumericsWatch(window=8, recorder=jrec)
    fired = []
    for s in seq:
        rec.append(dict(s))
        jrec.append(dict(s))
        got, want = w.observe(dict(s)), jw.observe(dict(s))
        assert got == want, s["step"]
        fired += got
    assert fired == ["loss_spike", "nonfinite", "overflow"]
    assert any("layer 4 family grad/x" in a["msg"] for a in w.alerts)
    dumps = sorted(tmp_path.glob("numerics_*.json"))
    assert dumps
    rec_json = json.loads(dumps[-1].read_text())
    assert len(rec_json["snapshots"]) == 4
