"""BERT encoder family (counterpart of ``paddle_tpu/models/bert.py``).

Same configuration, parameter names, layouts and numerics as the JAX
models: weights keep the JAX (in, out) layout (``x @ w``); the block is
post-LN with a fused QKV projection, its LayerNorms in fp32 with eps
1e-12 and the population variance, its GELU the tanh form
(``jax.nn.gelu``'s default). Attention is ``F.scaled_dot_product_attention``
with the (B, 1, 1, S) -1e30 padding bias and ``kv_lens`` (the flash
kernels K1/K3/K4 on the card; no attention dropout, as in JAX).
``kv_lens`` is derived on the device from ``attention_mask``: a row
whose valid keys are a contiguous prefix declares its length, a row
with holes keeps S and relies on the bias alone; nothing is read back
to the host.

Dropout is the JAX one: layer i's key is ``fold_in(rng_key, i)``, the
residual branch after attention drops with ``fold_in(key, 1)`` and the
FFN's with ``fold_in(key, 2)`` (``bernoulli(1 - p)`` over the
activation, ``paddle_tpu_torch.random``'s bits of ``jax.random``); no
key, no dropout.

A trunk holds its layers per layer (``layers.item_<i>.<name>``, the
JAX ``split_params()`` keys) or, after ``init_train_state(stacked=True)``,
in (L, ...) slabs under ``_stacked_layers.<name>`` (the JAX
``{prefix}_stacked_layers`` entry); ``Bert.stack_layers`` /
``unstack_layers`` move the weights between the two. A Python loop over
the layers replaces the scan. ``BertForPretraining`` (MLM + NSP, the
decoder tied to ``wte``), ``BertForSequenceClassification``, the
losses and ``build_pretrain_step`` follow the JAX functions. The
``mesh`` arguments (tensor-parallel vocab, ``PARTITION_RULES``,
``shard_params``) raise: distributed training is ROADMAP item 9.
Random weights come from a seeded ``torch.Generator`` (the parity tests
load the JAX weights through ``models/convert.py``).
"""

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as torch_F
from torch import nn

from paddle_tpu_torch import device as device_lib
from paddle_tpu_torch import dtypes
from paddle_tpu_torch import random as prng
from paddle_tpu_torch.incubate.moe import draw_param
from paddle_tpu_torch.models.gpt import (_maybe_dropout, check_step_params,
                                         final_ln, finish_step,
                                         register_slab_decay_masks)
from paddle_tpu_torch.nn.functional import (cross_entropy,
                                            scaled_dot_product_attention)
from paddle_tpu_torch.observability import numerics

__all__ = ["BertConfig", "BertLayer", "Bert", "BertForPretraining",
           "BertForSequenceClassification", "mlm_loss", "pretrain_loss",
           "build_pretrain_step", "init_train_state", "layer_param_specs",
           "trunk_param_specs", "padding_bias", "masked_positions",
           "trunk_of", "bert_tiny", "bert_base", "bert_large"]

LN_EPS = 1e-12
STACKED = "_stacked_layers"


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "a mesh (tensor-parallel vocab, PARTITION_RULES, "
            "shard_params) is not ported: distributed training waits for "
            "the torch.distributed slice (ROADMAP item 9)")


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30528
    max_position: int = 512
    type_vocab_size: int = 2
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_mult: int = 4
    dropout: float = 0.1
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        object.__setattr__(self, "dtype", dtypes.to_dtype(self.dtype))

    @property
    def head_dim(self):
        return self.d_model // self.n_heads

    @property
    def d_ffn(self):
        return self.d_model * self.ffn_mult

    def num_params(self, non_embedding: bool = False) -> int:
        d = self.d_model
        per_layer = 4 * d * d + 2 * d * self.d_ffn + 9 * d + self.d_ffn
        n = self.n_layers * per_layer + 2 * d
        if not non_embedding:
            n += (self.vocab_size + self.max_position
                  + self.type_vocab_size) * d
        return n

    def flops_per_token(self) -> float:
        """fwd+bwd model FLOPs per token (6N + attention term)."""
        n = self.num_params(non_embedding=True)
        attn = 12 * self.n_layers * self.d_model * self.max_position
        return 6 * n + attn


def layer_param_specs(cfg: BertConfig) -> Dict[str, tuple]:
    """name -> (per-layer shape, dtype, init) of one block's parameters,
    in the JAX names; init is "ones", "zeros" or a std."""
    d, f, dt, f32 = cfg.d_model, cfg.d_ffn, cfg.dtype, torch.float32
    return {"wqkv": ((d, 3 * d), dt, 0.02), "bqkv": ((3 * d,), dt, "zeros"),
            "wo": ((d, d), dt, 0.02), "bo": ((d,), dt, "zeros"),
            "wup": ((d, f), dt, 0.02), "bup": ((f,), dt, "zeros"),
            "wdown": ((f, d), dt, 0.02), "bdown": ((d,), dt, "zeros"),
            "ln1_scale": ((d,), f32, "ones"),
            "ln1_bias": ((d,), f32, "zeros"),
            "ln2_scale": ((d,), f32, "ones"),
            "ln2_bias": ((d,), f32, "zeros")}


def trunk_param_specs(cfg: BertConfig) -> Dict[str, tuple]:
    """name -> (shape, dtype, init) of the trunk's non-layer
    parameters."""
    d, dt, f32 = cfg.d_model, cfg.dtype, torch.float32
    return {"wte": ((cfg.vocab_size, d), dt, 0.02),
            "wpe": ((cfg.max_position, d), dt, 0.02),
            "wtype": ((cfg.type_vocab_size, d), dt, 0.02),
            "emb_ln_scale": ((d,), f32, "ones"),
            "emb_ln_bias": ((d,), f32, "zeros"),
            "pooler_w": ((d, d), dt, 0.02),
            "pooler_b": ((d,), dt, "zeros")}


def _generator(dev, seed: int, salt: int) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) * 1000003 + salt)
    return gen


def _draw_into(module, specs, gen, dev):
    for n, (shape, dt, init) in specs.items():
        module.register_parameter(
            n, nn.Parameter(draw_param(shape, dt, init, gen, dev)))


class BertLayer(nn.Module):
    """The post-LN encoder block. It holds no weights: ``forward`` takes
    ``w``, one layer's name -> tensor map (an entry of
    ``Bert.layer_weights``)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.n_heads = cfg.n_heads
        self.head_dim = cfg.head_dim
        self.dropout = cfg.dropout

    def forward(self, x, w, attn_bias=None, rng_key=None, kv_lens=None,
                attn: Optional[Callable] = None):
        b, s, d = x.shape
        qkv = (x @ w["wqkv"] + w["bqkv"]).reshape(b, s, 3, self.n_heads,
                                                  self.head_dim)
        q, k, v = (qkv[:, :, i].contiguous() for i in range(3))
        a = (attn or scaled_dot_product_attention)(
            q, k, v, attn_mask=attn_bias, is_causal=False, dropout_p=0.0,
            kv_lens=kv_lens)
        a = a.reshape(b, s, d).to(x.dtype) @ w["wo"] + w["bo"]
        a = _maybe_dropout(a, self.dropout, rng_key, 1)
        x = final_ln(x + a, w["ln1_scale"], w["ln1_bias"], LN_EPS)
        h = torch_F.gelu(x @ w["wup"] + w["bup"], approximate="tanh")
        h = h @ w["wdown"] + w["bdown"]
        h = _maybe_dropout(h, self.dropout, rng_key, 2)
        return final_ln(x + h, w["ln2_scale"], w["ln2_bias"], LN_EPS)


def padding_bias(attention_mask):
    """(B, S) 1 = keep -> (the (B, 1, 1, S) fp32 additive bias, 0 or the
    finite -1e30, and the (B,) int32 ``kv_lens``: a contiguous valid
    prefix declares its length, a row with holes keeps S), both on the
    mask's device with no read-back (JAX bert.py:180-195)."""
    keep = attention_mask.bool()
    s = keep.shape[-1]
    bias = torch.where(keep[:, None, None, :], 0.0, -1e30).to(
        torch.float32)
    lens = keep.to(torch.int32).sum(-1, dtype=torch.int32)
    prefix = torch.arange(s, device=keep.device)[None, :] < lens[:, None]
    is_prefix = (keep == prefix).all(-1)
    kv_lens = torch.where(is_prefix, lens, s).to(torch.int32).contiguous()
    return bias, kv_lens


class Bert(nn.Module):
    """Encoder trunk: embeddings -> L layers -> (sequence_output,
    pooled). ``Bert(cfg, seed, device)`` draws random weights; the
    layers start per layer (``layers.item_<i>``)."""

    def __init__(self, cfg: BertConfig, seed: int = 0, device=None):
        super().__init__()
        dev = device_lib.resolve(device)
        self.cfg = cfg
        _draw_into(self, trunk_param_specs(cfg), _generator(dev, seed, 0),
                   dev)
        gen = _generator(dev, seed, 1)
        self.layers = nn.Module()
        for i in range(cfg.n_layers):
            item = nn.Module()
            _draw_into(item, layer_param_specs(cfg), gen, dev)
            self.layers.add_module(f"item_{i}", item)
        self.block = BertLayer(cfg)

    @property
    def is_stacked(self) -> bool:
        return self.layers is None

    def stack_layers(self):
        """Move the per-layer weights into (L, ...) slabs
        (``_stacked_layers.<name>``, new parameters)."""
        if self.is_stacked:
            return
        items = list(self.layers.children())
        slabs = nn.ParameterDict({
            n: nn.Parameter(torch.stack([getattr(m, n).detach()
                                         for m in items]))
            for n in layer_param_specs(self.cfg)})
        self.layers = None
        self.add_module(STACKED, slabs)

    def unstack_layers(self):
        """Move the slabs back into per-layer weights."""
        if not self.is_stacked:
            return
        slabs = getattr(self, STACKED)
        layers = nn.Module()
        for i in range(self.cfg.n_layers):
            item = nn.Module()
            for n, t in slabs.items():
                item.register_parameter(n, nn.Parameter(
                    t.detach()[i].clone()))
            layers.add_module(f"item_{i}", item)
        delattr(self, STACKED)
        self.layers = layers

    def slab_entries(self, prefix: str = ""):
        """The slabs' parameter names (``{prefix}_stacked_layers.<name>``);
        none per layer."""
        if not self.is_stacked:
            return []
        return [f"{prefix}{STACKED}.{n}" for n in getattr(self, STACKED)]

    def layer_weights(self):
        """Per-layer name -> tensor maps: the layers' own parameters, or
        one ``unbind(0)`` per slab (differentiable views)."""
        if not self.is_stacked:
            return [dict(m.named_parameters())
                    for m in self.layers.children()]
        slabs = getattr(self, STACKED)
        names = list(slabs.keys())
        return [dict(zip(names, ts))
                for ts in zip(*(slabs[n].unbind(0) for n in names))]

    def forward(self, tokens, token_type_ids=None, attention_mask=None,
                rng_key=None, extra_embed=None,
                attn: Optional[Callable] = None):
        """(B, S) tokens -> ((B, S, d) sequence output, (B, d) pooled).
        ``extra_embed``: an additive plane folded in before the embedding
        LayerNorm (ERNIE's task-type embedding). ``attn`` replaces the
        attention functional (same signature as
        ``scaled_dot_product_attention``)."""
        s = tokens.shape[1]
        x = torch_F.embedding(tokens, self.wte) + self.wpe[:s]
        if token_type_ids is not None:
            x = x + torch_F.embedding(token_type_ids, self.wtype)
        else:
            x = x + self.wtype[0]
        if extra_embed is not None:
            x = x + extra_embed
        x = final_ln(x, self.emb_ln_scale, self.emb_ln_bias, LN_EPS)
        attn_bias = kv_lens = None
        if attention_mask is not None:
            attn_bias, kv_lens = padding_bias(attention_mask)
        for i, w in enumerate(self.layer_weights()):
            k = prng.fold_in(rng_key, i) if rng_key is not None else None
            x = self.block(x, w, attn_bias, k, kv_lens, attn)
        pooled = torch.tanh(x[:, 0] @ self.pooler_w + self.pooler_b)
        return x, pooled


class BertForPretraining(nn.Module):
    """MLM + NSP heads, the MLM decoder tied to ``bert.wte``."""

    def __init__(self, cfg: BertConfig, seed: int = 0, device=None):
        super().__init__()
        dev = device_lib.resolve(device)
        self.cfg = cfg
        self.bert = Bert(cfg, seed, dev)
        d, dt, f32 = cfg.d_model, cfg.dtype, torch.float32
        _draw_into(self, {
            "mlm_transform_w": ((d, d), dt, 0.02),
            "mlm_transform_b": ((d,), dt, "zeros"),
            "mlm_ln_scale": ((d,), f32, "ones"),
            "mlm_ln_bias": ((d,), f32, "zeros"),
            "mlm_bias": ((cfg.vocab_size,), f32, "zeros"),
            "nsp_w": ((d, 2), dt, 0.02), "nsp_b": ((2,), dt, "zeros")},
            _generator(dev, seed, 999), dev)

    def mlm_head(self, h):
        """Transform + LN + tied vocab projection over (..., d) states;
        the logits in fp32 (the fp32 ``mlm_bias`` promotes them)."""
        h = torch_F.gelu(h @ self.mlm_transform_w + self.mlm_transform_b,
                         approximate="tanh")
        h = final_ln(h, self.mlm_ln_scale, self.mlm_ln_bias, LN_EPS)
        return h @ self.bert.wte.t() + self.mlm_bias

    def forward(self, tokens, token_type_ids=None, attention_mask=None,
                rng_key=None, mlm_positions=None,
                attn: Optional[Callable] = None):
        """(MLM logits, NSP logits). ``mlm_positions`` (B, M): the MLM
        logits only at those positions, gathered before the vocab
        projection: (B, M, V); else (B, S, V)."""
        seq, pooled = self.bert(tokens, token_type_ids, attention_mask,
                                rng_key, attn=attn)
        if mlm_positions is not None:
            idx = mlm_positions.long()[..., None].expand(
                -1, -1, seq.shape[-1])
            seq = seq.gather(1, idx)
        return (self.mlm_head(seq), pooled @ self.nsp_w + self.nsp_b)


class BertForSequenceClassification(nn.Module):
    """The fine-tune head: ``pooled @ cls_w + cls_b``."""

    def __init__(self, cfg: BertConfig, num_classes: int = 2,
                 seed: int = 0, device=None):
        super().__init__()
        dev = device_lib.resolve(device)
        self.cfg = cfg
        self.bert = Bert(cfg, seed, dev)
        _draw_into(self, {
            "cls_w": ((cfg.d_model, num_classes), cfg.dtype, 0.02),
            "cls_b": ((num_classes,), cfg.dtype, "zeros")},
            _generator(dev, seed, 12345), dev)

    def forward(self, tokens, token_type_ids=None, attention_mask=None,
                rng_key=None, attn: Optional[Callable] = None):
        _, pooled = self.bert(tokens, token_type_ids, attention_mask,
                              rng_key, attn=attn)
        return pooled @ self.cls_w + self.cls_b


def mlm_loss(mlm_logits, labels, ignore_index: int = -100):
    """Masked-LM CE in fp32: positions at ``ignore_index`` count
    nothing."""
    return cross_entropy(mlm_logits.float(), labels,
                         ignore_index=ignore_index)


def pretrain_loss(mlm_logits, nsp_logits, mlm_labels, nsp_labels):
    return (mlm_loss(mlm_logits, mlm_labels)
            + cross_entropy(nsp_logits.float(), nsp_labels))


def trunk_of(model):
    """(encoder trunk, its parameter-name prefix) of a BERT-family model
    whose trunk is its own ``.bert`` (or the trunk itself)."""
    if isinstance(model, Bert):
        return model, ""
    trunk = getattr(model, "bert", None)
    if not isinstance(trunk, Bert):
        raise ValueError(
            f"{type(model).__name__} does not expose a .bert trunk; the "
            "stacked layout supports Bert and the Bert* heads")
    return trunk, "bert."


def masked_positions(mlm_labels, max_predictions: int):
    """(positions, labels) of the first ``max_predictions`` slots after
    a stable sort that puts the masked positions (label != -100) first,
    as ``jnp.argsort(labels == -100, stable=True)`` orders them."""
    order = torch.argsort((mlm_labels == -100).to(torch.int32), dim=1,
                          stable=True)
    pos = order[:, :max_predictions]
    return pos, mlm_labels.gather(1, pos)


def build_pretrain_step(model: BertForPretraining, optimizer,
                        mesh=None, max_predictions: Optional[int] = None,
                        attn: Optional[Callable] = None):
    """``step(params, opt_state, tokens, type_ids, attn_mask,
    mlm_labels, nsp_labels, rng=None) -> (params, opt_state, loss)``:
    forward with dropout drawn from ``rng``, ``pretrain_loss``,
    backward, optimizer update in place (``params`` is the dict
    ``init_train_state`` returned; each parameter's ``.grad`` keeps the
    step's gradient). ``max_predictions`` computes the vocab head only
    on the first M masked slots (``masked_positions``). ``attn``
    replaces the attention functional (the plain versions, to hold the
    kernels against). With ``PT_NUMERICS_EVERY`` > 0 when the step is
    built it returns a 4th output, the packed numerics vector
    (``step.numerics_layout`` decodes it); the gradients pass the
    ``train.grad_poison`` site before the update."""
    _no_mesh(mesh)
    trunk, prefix = trunk_of(model)
    own = dict(model.named_parameters())
    slabs = trunk.slab_entries(prefix)
    num_on = numerics.enabled()
    num_box = numerics.LayoutBox()

    def step(params, opt_state, tokens, type_ids, attn_mask, mlm_labels,
             nsp_labels, rng=None):
        check_step_params(own, params, optimizer, slabs)
        pos, labels = None, mlm_labels
        if max_predictions is not None:
            pos, labels = masked_positions(mlm_labels, max_predictions)
        mlm_logits, nsp_logits = model(tokens, type_ids, attn_mask,
                                       rng_key=rng, mlm_positions=pos,
                                       attn=attn)
        loss = pretrain_loss(mlm_logits, nsp_logits, labels, nsp_labels)
        return finish_step(own, slabs, optimizer, params, opt_state, loss,
                           num_on, num_box)

    step.numerics_layout = num_box
    return step


def init_train_state(model, optimizer, mesh=None, stacked: bool = False):
    """``(params, opt_state)``: the model's own parameters by name and
    the optimizer's state. ``stacked=True`` moves the trunk's layers
    into slabs (``{prefix}_stacked_layers.<name>``, the JAX stacked
    entry) and resolves ``apply_decay_param_fun`` per layer under the
    names ``{prefix}layers.item_<i>.<name>`` into masks over the slabs;
    ``stacked=False`` keeps (or moves back to) the per-layer names, on
    which the optimizer resolves the name fn itself. Only ``Bert`` and
    the heads with a ``.bert`` trunk stack (JAX raises for the ERNIE
    classifier's re-homed trunk, and so does the port)."""
    _no_mesh(mesh)
    if stacked:
        trunk, prefix = trunk_of(model)
        trunk.stack_layers()
        if getattr(optimizer, "apply_decay_param_fun", None) is not None:
            register_slab_decay_masks(
                optimizer,
                {f"{prefix}{STACKED}.{n}": (n, t)
                 for n, t in getattr(trunk, STACKED).items()},
                trunk.cfg.n_layers,
                lambda i, name: f"{prefix}layers.item_{i}.{name}")
    else:
        for m in model.modules():
            if isinstance(m, Bert):
                m.unstack_layers()
    params = dict(model.named_parameters())
    return params, optimizer.init(params)


def bert_tiny(**kw):
    d = dict(vocab_size=256, max_position=64, d_model=64, n_layers=2,
             n_heads=2, dropout=0.0, type_vocab_size=2,
             dtype=torch.float32)
    d.update(kw)
    return BertConfig(**d)


def bert_base(**kw):
    d = dict(d_model=768, n_layers=12, n_heads=12)
    d.update(kw)
    return BertConfig(**d)


def bert_large(**kw):
    d = dict(d_model=1024, n_layers=24, n_heads=16)
    d.update(kw)
    return BertConfig(**d)
