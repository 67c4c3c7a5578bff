"""GPT decoder-only LM (counterpart of ``paddle_tpu/models/gpt.py``).

Same configuration, parameter names, layouts and numerics as the JAX
model, for dense stacks: weights keep the JAX (in, out) layout
(``x @ w``), LayerNorm statistics run in fp32, GELU is the tanh form
(``jax.nn.gelu``'s default), rope uses the rotate-half convention.

Weights live in stacked (L, ...) slabs, one trainable ``nn.Parameter``
per block parameter (``GPT.stacked``, the counterpart of the JAX
``init_train_state(stacked=True)`` layout). ``GPTBlock`` holds no
weights: every method takes the layer's name -> tensor map, and
``GPT.layer_weights`` makes those maps with one ``unbind(0)`` per slab,
whose backward is one stack, so a step builds each slab's gradient once
rather than one slab-sized zero tensor per layer. The serving engine
takes the same maps once, detached (they see every in-place update). A
Python loop over the layers replaces the scan.

The train step (``init_train_state``, ``build_train_step``) takes the
fused cross-entropy (K5-K7) where the JAX package does; attention
backward runs K3/K4 on the card. MoE and dropout > 0 raise (dropout
masks come from ``jax.random`` and cannot be reproduced). ``dtype``
takes a ``torch.dtype`` or one of the names of ``paddle_tpu_torch.dtypes``.
"""

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as torch_F
from torch import nn
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch import device as device_lib
from paddle_tpu_torch import dtypes
from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
from paddle_tpu_torch.ops.fused_ce import fused_softmax_cross_entropy

__all__ = ["GPTConfig", "GPTBlock", "GPT", "final_ln", "block_param_specs",
           "lm_loss", "fused_lm_loss", "build_train_step",
           "init_train_state", "gpt_tiny", "gpt3_125m", "gpt3_350m",
           "gpt3_1p3b", "llama_style_1b"]


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304
    max_seq_len: int = 1024
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_mult: int = 4
    # any value > 0 makes GPT raise (the JAX masks are jax.random bits)
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    use_bias: bool = True
    tie_embeddings: bool = True
    # recompute each block in the backward (torch.utils.checkpoint)
    remat: bool = False
    # MoE is not ported: any value > 0 makes GPT raise
    moe_experts: int = 0
    # GQA/MQA: fewer KV heads than query heads; None = MHA
    n_kv_heads: Optional[int] = None
    # rotary positions instead of the learned wpe table
    rope: bool = False
    rope_theta: float = 10000.0

    def __post_init__(self):
        object.__setattr__(self, "dtype", dtypes.to_dtype(self.dtype))

    @property
    def head_dim(self):
        return self.d_model // self.n_heads

    @property
    def kv_heads(self):
        kv = self.n_kv_heads or self.n_heads
        if self.n_heads % kv:
            raise ValueError(
                f"n_heads {self.n_heads} not divisible by n_kv_heads {kv}")
        return kv

    @property
    def d_ffn(self):
        return self.d_model * self.ffn_mult

    def flops_per_token(self) -> float:
        """Model FLOPs per token (fwd+bwd), 6*N + attention term."""
        n = self.num_params(non_embedding=True)
        attn = 12 * self.n_layers * self.d_model * self.max_seq_len
        return 6 * n + attn

    def num_params(self, non_embedding: bool = False) -> int:
        d, L = self.d_model, self.n_layers
        kv_dim = self.kv_heads * self.head_dim
        per_layer = (d * (d + 2 * kv_dim) + d * d
                     + 2 * d * self.d_ffn + 4 * d)
        if self.use_bias:
            per_layer += (d + 2 * kv_dim) + 2 * d + self.d_ffn
        n = L * per_layer + 2 * d
        if not non_embedding:
            n += self.vocab_size * d
            if not self.rope:
                n += self.max_seq_len * d
            if not self.tie_embeddings:
                n += self.vocab_size * d
        return n


def block_param_specs(cfg: GPTConfig) -> Dict[str, tuple]:
    """name -> (per-layer shape, dtype, init) of one block's parameters,
    in the JAX package's names; init is ("ones"|"zeros"|std)."""
    d, f = cfg.d_model, cfg.d_ffn
    qkv = d + 2 * cfg.kv_heads * cfg.head_dim
    std, resid = 0.02, 0.02 / math.sqrt(2 * cfg.n_layers)
    f32, dt = torch.float32, cfg.dtype
    specs = {
        "ln1_scale": ((d,), f32, "ones"), "ln1_bias": ((d,), f32, "zeros"),
        "wqkv": ((d, qkv), dt, std), "wo": ((d, d), dt, resid),
        "ln2_scale": ((d,), f32, "ones"), "ln2_bias": ((d,), f32, "zeros"),
        "wup": ((d, f), dt, std), "wdown": ((f, d), dt, resid),
    }
    if cfg.use_bias:
        specs.update({"bqkv": ((qkv,), dt, "zeros"),
                      "bo": ((d,), dt, "zeros"),
                      "bup": ((f,), dt, "zeros"),
                      "bdown": ((d,), dt, "zeros")})
    return specs


def head_param_specs(cfg: GPTConfig) -> Dict[str, tuple]:
    """name -> (shape, dtype, init) of the non-block parameters."""
    d, dt = cfg.d_model, cfg.dtype
    specs = {"wte": ((cfg.vocab_size, d), dt, 0.02),
             "lnf_scale": ((d,), torch.float32, "ones"),
             "lnf_bias": ((d,), torch.float32, "zeros")}
    if not cfg.rope:
        specs["wpe"] = ((cfg.max_seq_len, d), dt, 0.01)
    if not cfg.tie_embeddings:
        specs["lm_head"] = ((d, cfg.vocab_size), dt, 0.02)
    return specs


def _init(shape, dtype, init, gen, dev):
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=dev)
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=dev)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
    return (x * init).to(dtype)


def final_ln(x, scale, bias, eps: float = 1e-5):
    """LayerNorm with fp32 statistics, output in x's dtype: the head's
    pre-projection norm (``GPT.head`` and the serving engine) and, as
    ``GPTBlock._ln``, the blocks' two norms."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * scale
            + bias).to(x.dtype)


class GPTBlock(nn.Module):
    """Pre-LN decoder block with fused QKV. It holds no weights: every
    method takes ``w``, a mapping of the JAX parameter names to one
    layer's tensors (an entry of ``GPT.layer_weights``); a bias-free
    config has no bias entries."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.n_heads = cfg.n_heads
        self.kv_heads = cfg.kv_heads
        self.head_dim = cfg.head_dim
        self.rope = cfg.rope
        self.rope_theta = cfg.rope_theta
        if cfg.rope and cfg.head_dim % 2:
            raise ValueError("rope needs an even head_dim")

    def _split_qkv(self, qkv):
        """(B, L, d+2·kv_dim) fused projection → contiguous q
        (B, L, H, D), k/v (B, L, Hkv, D)."""
        b, L = qkv.shape[:2]
        d = self.n_heads * self.head_dim
        kvd = self.kv_heads * self.head_dim
        q = qkv[..., :d].reshape(b, L, self.n_heads, self.head_dim)
        k = qkv[..., d:d + kvd].reshape(b, L, self.kv_heads, self.head_dim)
        v = qkv[..., d + kvd:].reshape(b, L, self.kv_heads, self.head_dim)
        return q.contiguous(), k.contiguous(), v.contiguous()

    def _apply_rope(self, x, positions):
        """Rotary embedding on (B, L, Hx, D) at absolute ``positions``
        (B, L) or (L,), rotate-half convention."""
        if not self.rope:
            return x
        half = self.head_dim // 2
        freqs = self.rope_theta ** (
            -torch.arange(0, half, dtype=torch.float32,
                          device=x.device) / half)
        ang = positions.to(torch.float32)[..., None] * freqs
        while ang.dim() < 3:
            ang = ang[None]
        cos = torch.cos(ang)[:, :, None, :]
        sin = torch.sin(ang)[:, :, None, :]
        x32 = x.float()
        x1, x2 = x32[..., :half], x32[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
        return out.to(x.dtype)

    def _ln(self, x, scale, bias):
        return final_ln(x, scale, bias)

    def _block_tail(self, x, attn, w):
        """Post-attention half of the block (out-proj + MLP), shared by
        the full forward and every cached-decode path."""
        o = attn @ w["wo"]
        if w.get("bo") is not None:
            o = o + w["bo"]
        x = x + o
        h = self._ln(x, w["ln2_scale"], w["ln2_bias"])
        h = h @ w["wup"]
        if w.get("bup") is not None:
            h = h + w["bup"]
        h = torch_F.gelu(h, approximate="tanh") @ w["wdown"]
        if w.get("bdown") is not None:
            h = h + w["bdown"]
        return x + h

    def _qkv(self, x, positions, w):
        """LN1 + fused QKV (+ rope at ``positions`` (B,), the first
        row's position per batch row). x: (B, K, d) → q (B,K,H,D), k/v
        (B,K,Hkv,D)."""
        K = x.shape[1]
        h = self._ln(x, w["ln1_scale"], w["ln1_bias"])
        qkv = h @ w["wqkv"]
        if w.get("bqkv") is not None:
            qkv = qkv + w["bqkv"]
        q, k, v = self._split_qkv(qkv)
        if self.rope:
            pos2 = positions[:, None] + torch.arange(K,
                                                     device=x.device)[None]
            q = self._apply_rope(q, pos2)
            k = self._apply_rope(k, pos2)
        return q, k, v

    def forward(self, x, w, attn: Optional[Callable] = None):
        """Full causal forward of (B, S, d). ``attn`` replaces the
        attention functional (same signature as
        ``scaled_dot_product_attention``); default the port's sdpa."""
        b, s, d = x.shape
        q, k, v = self._qkv(x, torch.zeros((b,), dtype=torch.int64,
                                           device=x.device), w)
        attn_fn = attn or scaled_dot_product_attention
        a = attn_fn(q, k, v, is_causal=True)
        return self._block_tail(x, a.reshape(b, s, d).to(x.dtype), w)


class GPT(nn.Module):
    """Decoder-only LM with learned positions (or rope), tied or untied
    head. ``GPT(cfg, seed)`` draws random weights from a seeded
    ``torch.Generator`` on ``device``; ``weights`` (name -> tensor, the
    JAX head names plus (L, ...) slabs under the block names) builds it
    from given tensors instead (``models/convert.py``). Every parameter
    is trainable: the head ones under their JAX names, the slabs as
    ``stacked.<block name>``."""

    def __init__(self, cfg: GPTConfig, seed: int = 0, device=None,
                 weights: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        if cfg.moe_experts > 0:
            raise NotImplementedError("MoE GPT is not ported (dense "
                                      "stacks only)")
        if cfg.dropout > 0:
            raise NotImplementedError(
                "dropout > 0 is not ported: the JAX package draws its "
                "masks from jax.random, which cannot be reproduced")
        dev = device_lib.resolve(device)
        self.cfg = cfg
        L = cfg.n_layers
        if weights is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
            weights = {n: _init(s, dt, init, gen, dev)
                       for n, (s, dt, init) in head_param_specs(cfg).items()}
            weights.update({
                n: _init((L, *s), dt, init, gen, dev)
                for n, (s, dt, init) in block_param_specs(cfg).items()})
        self.wpe = self.lm_head = None
        for n in head_param_specs(cfg):
            setattr(self, n, nn.Parameter(weights[n].detach()))
        self.stacked = nn.ParameterDict({
            n: nn.Parameter(weights[n].detach())
            for n in block_param_specs(cfg)})
        self.block = GPTBlock(cfg)

    def layer_weights(self):
        """Per-layer name -> tensor maps, one ``unbind(0)`` per slab (views
        of the slabs, differentiable)."""
        names = list(self.stacked.keys())
        layers = zip(*(self.stacked[n].unbind(0) for n in names))
        return [dict(zip(names, ts)) for ts in layers]

    def embed(self, tokens):
        x = self.wte[tokens]
        if self.wpe is not None:
            x = x + self.wpe[:tokens.shape[-1]]
        return x

    def head(self, x):
        x = final_ln(x, self.lnf_scale, self.lnf_bias)
        w = self.wte.t() if self.lm_head is None else self.lm_head
        return x @ w

    def hidden_states(self, tokens, attn: Optional[Callable] = None):
        """Final hidden states (B, S, d): forward minus the LM head. With
        ``cfg.remat`` each block is recomputed in the backward
        (``jax.checkpoint`` per block in the JAX package)."""
        x = self.embed(tokens)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for w in self.layer_weights():
            if remat:
                x = checkpoint(self.block, x, w, attn, use_reentrant=False)
            else:
                x = self.block(x, w, attn)
        return x

    @torch.no_grad()
    def forward(self, tokens, attn: Optional[Callable] = None):
        """(B, S) int tokens → (B, S, V) logits in the model dtype."""
        return self.head(self.hidden_states(tokens, attn))


# ---------------------------------------------------------------------------
# Loss and train step (counterparts of gpt.py:1029-1090, :1138, :1220)
# ---------------------------------------------------------------------------

def lm_loss(logits, labels):
    """Causal LM next-token loss of (B, S, V) logits, softmax in fp32
    (the JAX package's dense path)."""
    logits = logits[:, :-1].float()
    labels = labels[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels[..., None])[..., 0]
    return (logz - picked).mean()


def _use_fused_ce(cfg) -> bool:
    """Where the JAX package routes the train loss through the fused CE:
    a dense stack whose vocab has a 128-multiple block divisor, that is
    a vocab that is a multiple of 128 (the port has no kernel flag and
    no multi-device mesh; its kernels mask a ragged vocab tile, so the
    rule only keeps the two packages on the same loss path)."""
    return cfg.moe_experts == 0 and cfg.vocab_size % 128 == 0


def fused_lm_loss(m: GPT, tokens, attn: Optional[Callable] = None,
                  ce: Optional[Callable] = None):
    """Causal LM loss with head-LN + LM projection + softmax-CE fused
    (K5-K7 on the card), so the (B, S, V) logits never exist in device
    memory; ``forward`` + ``lm_loss`` where the fused CE does not apply.
    ``attn`` replaces the attention functional, ``ce`` the fused CE
    (same signature as ``fused_softmax_cross_entropy``)."""
    if not _use_fused_ce(m.cfg):
        return lm_loss(m.head(m.hidden_states(tokens, attn)), tokens)
    x = m.hidden_states(tokens, attn)
    b, s, d = x.shape
    xn = final_ln(x, m.lnf_scale, m.lnf_bias)
    w = m.wte if m.lm_head is None else m.lm_head.t()   # (V, d)
    rows = xn[:, :-1].reshape(b * (s - 1), d)
    labels = tokens[:, 1:].reshape(-1)
    per_tok = (ce or fused_softmax_cross_entropy)(rows, w, labels)
    return per_tok.sum() / (b * (s - 1))


def init_train_state(model: GPT, optimizer):
    """``(params, opt_state)``: the model's own parameters by name (the
    slabs stacked, as the JAX ``stacked=True`` state) and the
    optimizer's ``{"step", "slots"}``. A name-keyed
    ``apply_decay_param_fun`` cannot see into the slabs; per-layer decay
    masks are ROADMAP T3, so it raises here."""
    if getattr(optimizer, "apply_decay_param_fun", None) is not None:
        raise NotImplementedError(
            "apply_decay_param_fun over the stacked block slabs needs "
            "per-layer decay masks (ROADMAP T3)")
    params = dict(model.named_parameters())
    return params, optimizer.init(params)


def build_train_step(model: GPT, optimizer,
                     attn: Optional[Callable] = None,
                     ce: Optional[Callable] = None):
    """``step(params, opt_state, tokens) -> (params, opt_state, loss)``:
    forward, ``fused_lm_loss``, backward, optimizer update. ``params``
    is the dict ``init_train_state`` returned; the step trains the model
    in place (the new parameters are the same tensors) and leaves this
    step's gradients in each parameter's ``.grad``. ``attn`` and ``ce``
    replace the attention and the fused CE (the plain versions, to hold
    the kernels against)."""
    own = dict(model.named_parameters())

    def step(params, opt_state, tokens):
        if params.keys() != own.keys() or any(
                params[n] is not p for n, p in own.items()):
            raise ValueError("params must be the model's own parameter "
                             "dict (init_train_state)")
        for p in own.values():
            p.grad = None
        loss = fused_lm_loss(model, tokens, attn, ce)
        loss.backward()
        grads = {n: p.grad for n, p in own.items()}
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, loss.detach()

    return step


# ---------------------------------------------------------------------------
# Presets (the JAX package's PaddleNLP gpt-3 family sizes)
# ---------------------------------------------------------------------------

def gpt_tiny(**kw):
    d = dict(vocab_size=256, max_seq_len=64, d_model=64, n_layers=2,
             n_heads=2, dtype=torch.float32)
    d.update(kw)
    return GPTConfig(**d)


def gpt3_125m(**kw):
    d = dict(d_model=768, n_layers=12, n_heads=12)
    d.update(kw)
    return GPTConfig(**d)


def gpt3_350m(**kw):
    d = dict(d_model=1024, n_layers=24, n_heads=16)
    d.update(kw)
    return GPTConfig(**d)


def gpt3_1p3b(**kw):
    d = dict(d_model=2048, n_layers=24, n_heads=16, max_seq_len=2048)
    d.update(kw)
    return GPTConfig(**d)


def llama_style_1b(**kw):
    """Llama-family shape: rope positions, GQA kv heads, no biases,
    untied head."""
    d = dict(d_model=2048, n_layers=22, n_heads=16, n_kv_heads=4,
             rope=True, use_bias=False, tie_embeddings=False,
             max_seq_len=2048, vocab_size=32000)
    d.update(kw)
    return GPTConfig(**d)
