"""The port's BERT/ERNIE family (``models/bert.py``, ``models/ernie.py``,
``nn.functional.cross_entropy``, the BERT half of ``models/convert.py``)
against the JAX package's, in fp32 on the CPU at ``bert_tiny`` /
``ernie3_micro`` widths with dropout 0.1.

Both sides start from the same weights (the JAX model's parameters with
seeded noise, loaded through ``bert_from_jax_state``) and take the same
keys: the residual dropout masks come from ``paddle_tpu_torch.random``,
the bits of ``jax.random``, so they agree exactly. The JAX attention on
the CPU is its XLA reference with the padding bias; the port's CPU sdpa
is its reference, and with ``attn=`` the flash kernels' plain version,
which also takes ``kv_lens`` (a row with an interior hole must keep S).
Tolerances: fp32 forward 2e-5; losses 1e-5 relative; step-1 gradients
1e-4 relative L2; parameters after 3 AdamW steps 2e-5, except entries
whose step-1 gradient is at the rounding-noise level (the key bias's
true gradient is 0), which may take opposite steps of lr (see
``test_torch_train_step.py``)."""

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jax_optim
from paddle_tpu.models import bert as jax_bert
from paddle_tpu.models import ernie as jax_ernie
from paddle_tpu.nn import functional as jax_F
from paddle_tpu.nn.module import Module as JaxModule
from paddle_tpu_torch import random as prng
from paddle_tpu_torch.models import bert, ernie
from paddle_tpu_torch.models.convert import (bert_from_jax_state,
                                             bert_to_jax_state)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional.attention import mask_to_bias
from paddle_tpu_torch.ops.flash_attention import flash_attention_plain
from paddle_tpu_torch.optimizer import AdamW
from torch_reference_compile import fast_reference_compiles  # noqa: F401

ATOL = RTOL = 2e-5
LOSS_TOL, GRAD_TOL, P_TOL, NOISE, NOISE_ATOL = 1e-5, 1e-4, 2e-5, 1e-4, 6.1e-3
B, S = 3, 24
P = 0.1


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _noisy_state(jmodel, seed, std=0.1):
    """The JAX model's parameters with seeded values (LN scales around 1,
    the rest N(0, std)), set on the JAX model; returns them as numpy."""
    rs = np.random.RandomState(seed)
    state = {}
    for k, v in sorted(jmodel.state_dict().items()):
        noise = rs.randn(*v.shape).astype(np.float32)
        state[k] = (1.0 + 0.1 * noise) if "scale" in k else std * noise
    jmodel.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    return state


@functools.lru_cache(maxsize=None)
def _jax_model(kind):
    """One JAX model of each kind per test process (its random init runs
    op by op, about 2 s); each test sets its own weights on it."""
    if kind == "pretrain":
        return jax_bert.BertForPretraining(jax_bert.bert_tiny(dropout=P))
    if kind == "classify":
        return jax_bert.BertForSequenceClassification(
            jax_bert.bert_tiny(dropout=P), 3)
    return jax_ernie.ErnieForSequenceClassification(
        jax_ernie.ernie3_micro(dropout=P), 2)


@functools.lru_cache(maxsize=None)
def _jax_forward(kind):
    """The JAX model's forward, jitted once per kind with its parameters
    as an argument: ``f(params, *forward args)``."""
    jm = _jax_model(kind)
    return jax.jit(lambda p, *args: jm.merge_params(p)(*args))


def _pair(kind, seed=1):
    """(JAX model, port model) with the same weights."""
    jm = _jax_model(kind)
    if kind == "pretrain":
        pm = bert.BertForPretraining(bert.bert_tiny(dropout=P),
                                     device="cpu")
    elif kind == "classify":
        pm = bert.BertForSequenceClassification(
            bert.bert_tiny(dropout=P), 3, device="cpu")
    else:
        pm = ernie.ErnieForSequenceClassification(
            ernie.ernie3_micro(dropout=P), 2, device="cpu")
    bert_from_jax_state(pm, _noisy_state(jm, seed))
    return jm, pm


def _jax_run(kind, jm, *args):
    return _jax_forward(kind)(jm.split_params()[0], *args)


def _batch(vocab, mask_kind="prefix", seed=2):
    rs = np.random.RandomState(seed)
    tok = rs.randint(0, vocab, (B, S)).astype(np.int32)
    typ = rs.randint(0, 2, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    if mask_kind in ("prefix", "hole"):
        mask[1, 15:] = 0
        mask[2, 9:] = 0
    if mask_kind == "hole":
        mask[0, 5:8] = 0            # an interior hole: kv_lens keeps S
        mask[2, 3] = 0
    return tok, typ, mask


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _flash_plain(q, k, v, attn_mask=None, kv_lens=None, **_):
    """The kernels' plain version under the sdpa hook's signature."""
    bias = None if attn_mask is None else mask_to_bias(attn_mask)
    return flash_attention_plain(q, k, v, kv_lens=kv_lens, bias=bias)


def _jax_flat(tree):
    """A JAX params/grads dict with any stacked module entry flattened
    into ``<entry>.<name>`` (L, ...) arrays, as numpy fp32."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, JaxModule):
            out.update({f"{k}.{n}": np.asarray(t, np.float32)
                        for n, t in v.named_parameters()})
        else:
            out[k] = np.asarray(v, np.float32)
    return out


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rng", [False, True], ids=["eval", "dropout"])
@pytest.mark.parametrize("mask_kind", ["none", "prefix", "hole"])
def test_pretraining_forward_matches_jax(mask_kind, rng):
    jm, pm = _pair("pretrain")
    tok, typ, mask = _batch(jm.cfg.vocab_size, mask_kind)
    jmask = None if mask_kind == "none" else jnp.asarray(mask)
    jkey = jax.random.PRNGKey(3) if rng else None
    want_mlm, want_nsp = _jax_run("pretrain", jm, jnp.asarray(tok),
                                  jnp.asarray(typ), jmask, jkey)
    pmask = None if mask_kind == "none" else _t(mask)
    pkey = prng.PRNGKey(3) if rng else None
    for attn in (None, _flash_plain):
        with torch.no_grad():
            mlm, nsp = pm(_t(tok), _t(typ), pmask, rng_key=pkey, attn=attn)
        np.testing.assert_allclose(mlm.numpy(), np.asarray(want_mlm),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(nsp.numpy(), np.asarray(want_nsp),
                                   atol=ATOL, rtol=RTOL)


def test_kv_lens_keeps_s_for_a_row_with_holes():
    """A contiguous prefix declares its length, a row with holes keeps
    S, an all-padding row 0 (a prefix of length 0), as JAX computes
    them; the bias is 0 / -1e30 over (B, 1, 1, S)."""
    mask = np.array([[1, 1, 1, 0, 0], [1, 0, 1, 1, 0], [1, 1, 1, 1, 1],
                     [0, 0, 0, 0, 0], [0, 1, 1, 1, 1]], np.int32)
    bias, kv_lens = bert.padding_bias(_t(mask))
    keep = jnp.asarray(mask).astype(bool)
    lens = jnp.sum(keep.astype(jnp.int32), axis=-1)
    is_prefix = jnp.all(keep == (jnp.arange(5)[None, :] < lens[:, None]),
                        axis=-1)
    want = np.asarray(jnp.where(is_prefix, lens, 5))
    assert kv_lens.dtype == torch.int32 and kv_lens.tolist() == \
        want.tolist() == [3, 5, 5, 0, 5]
    assert bias.shape == (5, 1, 1, 5) and bias.dtype == torch.float32
    np.testing.assert_array_equal(bias[:, 0, 0].numpy(),
                                  np.where(mask == 1, np.float32(0),
                                           np.float32(-1e30)))


@pytest.mark.parametrize("positions", [False, True],
                         ids=["full", "mlm_positions"])
def test_mlm_logits_match_jax(positions):
    jm, pm = _pair("pretrain", seed=4)
    tok, typ, mask = _batch(jm.cfg.vocab_size, seed=5)
    pos = np.random.RandomState(6).randint(0, S, (B, 5)).astype(np.int32)
    jpos = jnp.asarray(pos) if positions else None
    want, _ = _jax_run("pretrain", jm, jnp.asarray(tok), jnp.asarray(typ),
                       jnp.asarray(mask), None, jpos)
    with torch.no_grad():
        got, _ = pm(_t(tok), _t(typ), _t(mask),
                    mlm_positions=_t(pos) if positions else None)
    assert got.shape == ((B, 5, jm.cfg.vocab_size) if positions
                         else (B, S, jm.cfg.vocab_size))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_classifier_forward_matches_jax():
    jm, pm = _pair("classify", seed=7)
    tok, typ, mask = _batch(jm.cfg.vocab_size, "hole", seed=8)
    want = _jax_run("classify", jm, jnp.asarray(tok), jnp.asarray(typ),
                    jnp.asarray(mask), jax.random.PRNGKey(1))
    with torch.no_grad():
        got = pm(_t(tok), _t(typ), _t(mask), rng_key=prng.PRNGKey(1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


# ---------------------------------------------------------------------------
# cross_entropy
# ---------------------------------------------------------------------------

def _ce_inputs(seed=9):
    rs = np.random.RandomState(seed)
    x = rs.randn(4, 6, 7).astype(np.float32)
    lab = rs.randint(0, 7, (4, 6)).astype(np.int64)
    lab[0, :2] = -100
    lab[3, 5] = -100
    soft = rs.rand(4, 6, 7).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    w = (0.5 + rs.rand(7)).astype(np.float32)
    return x, lab, soft, w


_CE_CASES = {
    "mean": {}, "sum": {"reduction": "sum"}, "none": {"reduction": "none"},
    "weight_mean": {"weight": True},
    "weight_none": {"weight": True, "reduction": "none"},
    "smoothing": {"label_smoothing": 0.1},
    "soft": {"soft_label": True},
    "soft_smoothing": {"soft_label": True, "label_smoothing": 0.2},
    "probs": {"use_softmax": False},
    "axis1": {"axis": 1},
    "label_with_class_dim": {"expand": True},
    "ignore_index_3": {"ignore_index": 3},
}


@pytest.mark.parametrize("case", sorted(_CE_CASES))
def test_cross_entropy_matches_jax(case):
    kw = dict(_CE_CASES[case])
    x, lab, soft, w = _ce_inputs()
    if kw.pop("weight", False):
        kw["weight"] = w
    if kw.get("use_softmax") is False:
        x = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    label = soft if kw.get("soft_label") else lab
    if kw.get("axis") == 1:
        x = np.ascontiguousarray(x.transpose(0, 2, 1))
        label = lab
    if kw.pop("expand", False):
        label = lab[..., None]
    if "ignore_index" in kw:
        label = np.where(lab == -100, kw["ignore_index"], lab)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    want = np.asarray(jax_F.cross_entropy(jnp.asarray(x),
                                          jnp.asarray(label), **jkw))
    got = F.cross_entropy(_t(x), _t(label), **tkw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _decay_fn(name):
    """LayerNorm scales and biases exempt."""
    return re.search(r"ln\d*_(scale|bias)$", name) is None


def _mlm_labels(tok, mask, seed):
    rs = np.random.RandomState(seed)
    lab = np.full(tok.shape, -100, np.int32)
    pick = (rs.rand(*tok.shape) < 0.2) & (mask == 1)
    lab[pick] = tok[pick]
    return lab


def _step1_grads(jstate, b1=0.9):
    """The JAX step's step-1 gradients, read back from its AdamW state:
    after one step the fp32 first moment is ``(1 - b1) * g`` (from 0),
    so ``m / (1 - b1)`` is g to an fp32 ulp (a second jitted program for
    ``jax.grad`` would double the JAX compile time)."""
    out = {}
    for n, slot in jstate["slots"].items():
        if isinstance(slot, JaxModule):   # the stacked entry
            out.update({f"{n}.{name}": np.asarray(
                getattr(slot, name)[0], np.float32) / (1 - b1)
                for name in slot._params})
        else:
            out[n] = np.asarray(slot[0], np.float32) / (1 - b1)
    return out


def _check_params(got, jparams, jgrads):
    for n, p in got.items():
        want = jparams[n]
        g = np.abs(jgrads[n])
        atol = np.where(g > NOISE * g.max(), P_TOL, NOISE_ATOL)
        excess = np.abs(p - want) - atol
        assert excess.max() <= 0, (n, float(excess.max()))


@pytest.mark.parametrize("stacked", [False, True],
                         ids=["per_layer", "stacked"])
@pytest.mark.parametrize("max_pred", [None, 4], ids=["all", "max_pred4"])
def test_pretrain_steps_match_jax(max_pred, stacked):
    jm, pm = _pair("pretrain", seed=10)
    tok, typ, mask = _batch(jm.cfg.vocab_size, "hole", seed=11)
    lab = _mlm_labels(tok, mask, 12)
    nsp = np.array([0, 1, 1], np.int32)
    jb = [jnp.asarray(a) for a in (tok, typ, mask, lab, nsp)]
    tb = [_t(a) for a in (tok, typ, mask, lab, nsp)]

    jopt = jax_optim.AdamW(learning_rate=1e-3, weight_decay=0.01,
                           apply_decay_param_fun=_decay_fn)
    jparams, jstate = jax_bert.init_train_state(jm, jopt, stacked=stacked)
    jstep = jax_bert.build_pretrain_step(jm, jopt, donate=False,
                                         max_predictions=max_pred)
    topt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                 apply_decay_param_fun=_decay_fn)
    params, state = bert.init_train_state(pm, topt, stacked=stacked)
    step = bert.build_pretrain_step(pm, topt, max_predictions=max_pred)
    if stacked:
        assert set(topt._decay_masks) == {
            n for n in params if "_stacked_layers." in n}
        assert topt._decay_masks[
            "bert._stacked_layers.ln1_scale"].flatten().tolist() == [0, 0]
        assert topt._decay_masks[
            "bert._stacked_layers.wqkv"].flatten().tolist() == [1, 1]

    key = jax.random.PRNGKey(0)
    for i in range(3):
        jparams, jstate, jl = jstep(jparams, jstate, *jb, key)
        params, state, loss = step(params, state, *tb, prng.PRNGKey(0))
        np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_TOL,
                                   err_msg=f"loss of step {i + 1}")
        if i == 0:
            jgrads = _step1_grads(jstate)
            got = bert_to_jax_state(pm, grads=True, stacked=stacked)
            assert sorted(got) == sorted(jgrads)
            for n, g in got.items():
                assert _rel_l2(g, jgrads[n]) <= GRAD_TOL, n
    assert state["step"] == 3 == int(jstate["step"])
    _check_params(bert_to_jax_state(pm, stacked=stacked),
                  _jax_flat(jparams), jgrads)


def test_masked_positions_order_ties_as_jax():
    """The stable argsort puts the masked slots first in position order,
    then the rest in position order, as ``jnp.argsort(stable=True)``."""
    lab = np.full((4, 30), -100, np.int32)
    rs = np.random.RandomState(13)
    for r in range(4):
        lab[r, rs.choice(30, r * 3 + 1, replace=False)] = 7
    pos, labels = bert.masked_positions(_t(lab), 8)
    want = np.asarray(jnp.argsort(jnp.asarray(lab) == -100, axis=1,
                                  stable=True))[:, :8]
    np.testing.assert_array_equal(pos.numpy(), want)
    np.testing.assert_array_equal(labels.numpy(),
                                  np.take_along_axis(lab, want, 1))


def _finetune_jax(jm, jopt):
    def step(params, state, tok, typ, task, mask, labels, key):
        def loss_fn(p):
            logits = jm.merge_params(p)(tok, typ, task, mask, rng_key=key)
            return jax_F.cross_entropy(logits.astype(jnp.float32), labels)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, state = jopt.update(grads, state, params)
        return params, state, loss, grads
    return jax.jit(step)


def _finetune_port(pm, topt, params, state, tok, typ, task, mask, labels,
                   key):
    for p in params.values():
        p.grad = None
    loss = F.cross_entropy(pm(tok, typ, task, mask, rng_key=key).float(),
                           labels)
    loss.backward()
    params, state = topt.update({n: p.grad for n, p in params.items()},
                                state, params)
    return params, state, loss.detach()


@pytest.mark.parametrize("task_ids", [False, True], ids=["task0", "tasks"])
def test_ernie_classifier_forward_matches_jax(task_ids):
    jm, pm = _pair("ernie", seed=14)
    tok, typ, mask = _batch(jm.cfg.vocab_size, "prefix", seed=15)
    task = np.random.RandomState(16).randint(0, 3, (B, S)).astype(np.int32)
    jtask = jnp.asarray(task) if task_ids else None
    want = _jax_run("ernie", jm, jnp.asarray(tok), jnp.asarray(typ), jtask,
                    jnp.asarray(mask), jax.random.PRNGKey(2))
    with torch.no_grad():
        got = pm(_t(tok), _t(typ), _t(task) if task_ids else None,
                 _t(mask), rng_key=prng.PRNGKey(2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_ernie_finetune_steps_match_jax():
    jm, pm = _pair("ernie", seed=17)
    tok, typ, mask = _batch(jm.cfg.vocab_size, "hole", seed=18)
    task = np.random.RandomState(19).randint(0, 3, (B, S)).astype(np.int32)
    labels = np.array([1, 0, 1], np.int32)
    jb = [jnp.asarray(a) for a in (tok, typ, task, mask, labels)]
    tb = [_t(a) for a in (tok, typ, task, mask, labels)]
    jopt = jax_optim.AdamW(learning_rate=1e-3, weight_decay=0.01,
                           apply_decay_param_fun=_decay_fn)
    topt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                 apply_decay_param_fun=_decay_fn)
    jparams, jstate = jax_bert.init_train_state(jm, jopt)
    params, state = bert.init_train_state(pm, topt)
    assert sorted(params) == sorted(jparams)
    jstep = _finetune_jax(jm, jopt)
    for i in range(3):
        jparams, jstate, jl, jg = jstep(jparams, jstate, *jb,
                                        jax.random.PRNGKey(1))
        params, state, loss = _finetune_port(pm, topt, params, state, *tb,
                                             prng.PRNGKey(1))
        np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_TOL,
                                   err_msg=f"loss of step {i + 1}")
        if i == 0:
            jgrads = _jax_flat(jg)
            for n, g in bert_to_jax_state(pm, grads=True).items():
                assert _rel_l2(g, jgrads[n]) <= GRAD_TOL, n
    _check_params(bert_to_jax_state(pm), _jax_flat(jparams), jgrads)


# ---------------------------------------------------------------------------
# conversion, layouts, errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["pretrain", "classify", "ernie"])
def test_conversion_round_trips_every_key(kind):
    jm, pm = _pair(kind, seed=20)
    jparams = {k: np.asarray(v, np.float32)
               for k, v in jm.split_params()[0].items()}
    got = bert_to_jax_state(pm)
    assert sorted(got) == sorted(jparams)
    for n, v in got.items():
        np.testing.assert_array_equal(v, jparams[n], err_msg=n)
    trunk = pm.ernie if kind == "ernie" else pm
    jtrunk = jm.ernie if kind == "ernie" else jm
    prefix = "bert."
    # the stacked layout, both ways: the port's slabs against the JAX
    # stacked entry, loading either layout into either
    jst, _ = jax_bert.init_train_state(jtrunk, jax_optim.AdamW(),
                                       stacked=True)
    jst = _jax_flat(jst)
    bert.init_train_state(trunk, AdamW(), stacked=True)
    stacked = bert_to_jax_state(trunk, stacked=True)
    assert sorted(stacked) == sorted(jst)
    assert f"{prefix}_stacked_layers.wqkv" in stacked
    for n, v in stacked.items():
        np.testing.assert_array_equal(v, jst[n], err_msg=n)
    fresh_kind = {"pretrain": lambda: bert.BertForPretraining(
        bert.bert_tiny(), seed=5, device="cpu"),
        "classify": lambda: bert.BertForSequenceClassification(
            bert.bert_tiny(), 3, seed=5, device="cpu"),
        "ernie": lambda: ernie.ErnieForSequenceClassification(
            ernie.ernie3_micro(), seed=5, device="cpu")}[kind]
    for state in (got, bert_to_jax_state(pm, stacked=True)):
        fresh = bert_from_jax_state(fresh_kind(), state)
        for n, v in bert_to_jax_state(fresh).items():
            np.testing.assert_array_equal(v, jparams[n], err_msg=n)


def test_convert_raises_on_unmatched_keys_and_shapes():
    jm, pm = _pair("ernie", seed=21)
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    bad = dict(state)
    bad["ernie.bert.layers.item_0.wqkvx"] = bad.pop(
        "ernie.bert.layers.item_0.wqkv")
    with pytest.raises(KeyError, match="wqkvx"):
        bert_from_jax_state(pm, bad)
    bad = {k.replace("ernie.wtask", "wtask"): v for k, v in state.items()}
    with pytest.raises(KeyError, match="wtask"):
        bert_from_jax_state(pm, bad)
    bad = dict(state)
    bad["cls_w"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="cls_w"):
        bert_from_jax_state(pm, bad)


def test_mesh_and_ernie_classifier_stacking_raise():
    pm = bert.BertForPretraining(bert.bert_tiny(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
        bert.init_train_state(pm, AdamW(), mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
        bert.build_pretrain_step(pm, AdamW(), mesh=object())
    em = ernie.ErnieForSequenceClassification(ernie.ernie3_micro(),
                                              device="cpu")
    jem = _jax_model("ernie")
    with pytest.raises(ValueError, match="does not expose a .bert trunk"):
        jax_bert.init_train_state(jem, jax_optim.AdamW(), stacked=True)
    with pytest.raises(ValueError, match="does not expose a .bert trunk"):
        bert.init_train_state(em, AdamW(), stacked=True)


def test_configs_match_jax():
    for port_cfg, jax_cfg in (
            (bert.bert_base(), jax_bert.bert_base()),
            (bert.bert_large(), jax_bert.bert_large()),
            (ernie.ernie3_base(), jax_ernie.ernie3_base()),
            (ernie.ernie3_medium(), jax_ernie.ernie3_medium())):
        for f in dataclasses.fields(jax_cfg):
            if f.name != "dtype":
                assert getattr(port_cfg, f.name) == getattr(jax_cfg,
                                                            f.name)
        assert port_cfg.dtype == torch.bfloat16
        assert port_cfg.num_params() == jax_cfg.num_params()
        assert port_cfg.flops_per_token() == jax_cfg.flops_per_token()
