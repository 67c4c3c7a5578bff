"""GPT decoder-only LM (counterpart of ``paddle_tpu/models/gpt.py``).

Same configuration, parameter names, layouts and numerics as the JAX
model: weights keep the JAX (in, out) layout (``x @ w``), LayerNorm
statistics run in fp32, GELU is the tanh form (``jax.nn.gelu``'s
default), rope uses the rotate-half convention.

A dense stack keeps its weights in stacked (L, ...) slabs, one
trainable ``nn.Parameter`` per block parameter (``GPT.stacked``, the
counterpart of the JAX ``init_train_state(stacked=True)`` layout). An
MoE stack (``moe_experts`` > 0: every ``moe_every``-th block swaps its
FFN for ``incubate.moe``'s) mixes two kinds of block, which cannot
stack: it keeps one module of parameters per layer (``GPT.blocks``,
``blocks.item_<i>.<name>``, the expert parameters under
``blocks.item_<i>.moe.``), the counterpart of the JAX per-layer state
(``init_train_state(stacked=False)``), and no slabs. ``GPTBlock``
holds no weights: every method takes the layer's name -> tensor map,
and ``GPT.layer_weights`` makes those maps, for slabs with one
``unbind(0)`` per slab, whose backward is one stack, so a step builds
each slab's gradient once rather than one slab-sized zero tensor per
layer. The serving engine takes the same maps once, detached (they see
every in-place update). A Python loop over the layers replaces the
scan.

The train step (``init_train_state``, ``build_train_step``) takes the
fused cross-entropy (K5-K7) where the JAX package does; attention
backward runs K3/K4 on the card. It takes everything the JAX step takes
for a dense stack on one device: any optimizer of ``optimizer`` with a
schedule, a clip and a regularizer; ``apply_decay_param_fun``, resolved
per layer into masks over the slabs; dropout from a JAX-style key
(``paddle_tpu_torch.random``: ``fold_in(key, layer)``, then salt 1
after attention and 2 after the FFN, ``bernoulli(1 - p)`` over the
activation, the same bits as ``jax.random``); and the numerics capture
(``PT_NUMERICS_EVERY``). An MoE stack trains on ``lm_loss`` over full
logits plus ``moe_aux_weight`` times the summed load-balance aux, as
the JAX step does (no fused CE).

The cached-decode half (``GPTBlock.decode_rows`` / ``verify_step`` /
``decode_step`` over a step's ``cache_rows``, ``GPT.init_cache`` /
``embed_at`` / ``forward_cached``, ``generate``) keeps head-major
(B, Hkv, T, D) caches, written in place. One-token decode hands the
fresh row to the flash-decode kernel (K10), which writes it and attends
over the prefix and that row in one launch, when the cache is long
enough (``_use_decode_kernel``); everything else writes the rows and
takes the dense grouped einsum. A weight map entry may
be an int8 ``QuantTensor`` (``quantization.quantize_for_inference``),
whose ``x @ w`` runs K12. An MoE block routes each call's own tokens
(the prompt's B x S0, then B a decode step), as the JAX cached decode
does. ``dtype`` takes a
``torch.dtype`` or one of the names of ``paddle_tpu_torch.dtypes``.
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
from paddle_tpu_torch import random as prng
from paddle_tpu_torch.incubate.moe import (Routing, draw_param,
                                           expert_param_specs, moe_ffn)
from paddle_tpu_torch.observability import numerics
from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
from paddle_tpu_torch.ops.decode_attention import decode_attention
from paddle_tpu_torch.ops.fused_ce import fused_softmax_cross_entropy

__all__ = ["GPTConfig", "GPTBlock", "GPT", "CacheRows", "cache_rows",
           "final_ln", "block_param_specs", "layer_param_specs",
           "is_moe_layer",
           "lm_loss", "fused_lm_loss", "train_loss", "build_train_step",
           "init_train_state", "register_stacked_decay_mask",
           "register_slab_decay_masks", "check_step_params",
           "finish_step", "generate",
           "gpt_tiny", "gpt3_125m", "gpt3_350m", "gpt3_1p3b",
           "llama_style_1b"]

# the JAX flag ``decode_kernel_min_t`` (paddle_tpu/flags.py:194): the
# shortest cache whose one-token decode goes to K10
DECODE_KERNEL_MIN_T = 1024


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304
    max_seq_len: int = 1024
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_mult: int = 4
    # residual dropout after attention and after the FFN, drawn from the
    # key the forward is given (none without one)
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    use_bias: bool = True
    tie_embeddings: bool = True
    # recompute each block in the backward (torch.utils.checkpoint)
    remat: bool = False
    # MoE: every ``moe_every``-th block swaps its FFN for an
    # incubate.moe FFN of ``moe_experts`` experts; 0 experts = dense
    moe_experts: int = 0
    moe_every: int = 2
    moe_aux_weight: float = 0.01
    moe_gate: str = "gshard"
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


def is_moe_layer(cfg: GPTConfig, i: int) -> bool:
    """Whether block ``i`` swaps its FFN for the MoE."""
    return cfg.moe_experts > 0 and (i + 1) % cfg.moe_every == 0


def layer_param_specs(cfg: GPTConfig) -> Dict[str, tuple]:
    """Full per-layer name (``blocks.item_<i>.<name>``, the keys of the
    JAX ``GPT.split_params()``) -> (shape, dtype, init) of every block
    parameter. An MoE layer has no ``wup``/``wdown``/``bup``/``bdown``
    and has the expert parameters under ``moe.``."""
    dense = block_param_specs(cfg)
    experts = expert_param_specs(cfg.d_model, cfg.d_ffn, cfg.moe_experts,
                                 cfg.dtype)
    out = {}
    for i in range(cfg.n_layers):
        specs = dict(dense)
        if is_moe_layer(cfg, i):
            for n in ("wup", "wdown", "bup", "bdown"):
                specs.pop(n, None)
            specs.update({f"moe.{n}": v for n, v in experts.items()})
        out.update({f"blocks.item_{i}.{n}": v for n, v in specs.items()})
    return out


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


def final_ln(x, scale, bias, eps: float = 1e-5):
    """LayerNorm with fp32 statistics, output in x's dtype: the head's
    pre-projection norm (``GPT.head`` and the serving engine) and, as
    ``GPTBlock._ln``, the blocks' two norms."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * scale
            + bias).to(x.dtype)


def _use_decode_kernel(T: int) -> bool:
    """Whether one-token decode over a cache of length ``T`` runs the
    flash-decode kernel K10: a 128-multiple cache of at least
    ``DECODE_KERNEL_MIN_T`` (the JAX package's rule for its engine and
    ``generate``; the port has no kernel flag and no multi-device
    mesh)."""
    return T % 128 == 0 and T >= DECODE_KERNEL_MIN_T


@dataclasses.dataclass(frozen=True)
class CacheRows:
    """Where one step's K new rows per batch row go in head-major caches
    of length T: built once per step by ``cache_rows`` and shared by
    every layer, so the index tensors cost no launches per layer."""
    positions: torch.Tensor          # (B,) int32: each row's first position
    bi: torch.Tensor                 # (B, 1) batch index
    t: torch.Tensor                  # (B, K) cache rows written
    write: Optional[torch.Tensor]    # (B,) bool: False keeps the rows
    lengths: torch.Tensor            # (B,) int32: positions + K, at most T


def cache_rows(positions, K: int, T: int, write=None) -> CacheRows:
    """``CacheRows`` for K rows at per-row ``positions`` (B,). A window
    that would pass the cache's end starts at T - K, as
    ``lax.dynamic_update_slice`` clamps it; ``write`` (B,) bool marks
    the rows to write (a row marked False keeps its entries: the
    engine's idle and admitting slots)."""
    b = positions.shape[0]
    dev = positions.device
    start = positions.long().clamp(0, T - K)
    return CacheRows(
        positions=positions,
        bi=torch.arange(b, device=dev)[:, None],
        t=start[:, None] + torch.arange(K, device=dev)[None],
        write=write,
        lengths=(positions + K).clamp(max=T).to(torch.int32))


class GPTBlock(nn.Module):
    """Pre-LN decoder block with fused QKV. It holds no weights: every
    method takes ``w``, a mapping of the JAX parameter names to one
    layer's tensors (an entry of ``GPT.layer_weights``); a bias-free
    config has no bias entries. An MoE layer's map has no FFN entries
    and holds its expert parameters under ``"moe"``."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.n_heads = cfg.n_heads
        self.kv_heads = cfg.kv_heads
        self.head_dim = cfg.head_dim
        self.rope = cfg.rope
        self.rope_theta = cfg.rope_theta
        self.dropout = cfg.dropout
        if cfg.rope and cfg.head_dim % 2:
            raise ValueError("rope needs an even head_dim")
        self.routing = (Routing.for_gate(cfg.moe_experts, cfg.moe_gate)
                        if cfg.moe_experts > 0 else None)

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

    def _block_tail(self, x, attn, w, rng_key=None, aux_acc=None):
        """Post-attention half of the block (out-proj + MLP or MoE),
        shared by the full forward and every cached-decode path; with a
        key, the residual dropout of each branch (salts 1 and 2) and the
        MoE's jitter (the layer's key itself, as the JAX block passes
        it). An MoE layer appends its aux loss to ``aux_acc``."""
        o = attn @ w["wo"]
        if w.get("bo") is not None:
            o = o + w["bo"]
        x = x + _maybe_dropout(o, self.dropout, rng_key, 1)
        h = self._ln(x, w["ln2_scale"], w["ln2_bias"])
        if "moe" in w:
            h, aux = moe_ffn(w["moe"], h, self.routing, rng_key)
            if aux_acc is not None:
                aux_acc.append(aux)
            return x + _maybe_dropout(h, self.dropout, rng_key, 2)
        h = h @ w["wup"]
        if w.get("bup") is not None:
            h = h + w["bup"]
        h = torch_F.gelu(h, approximate="tanh") @ w["wdown"]
        if w.get("bdown") is not None:
            h = h + w["bdown"]
        return x + _maybe_dropout(h, self.dropout, rng_key, 2)

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

    def forward(self, x, w, attn: Optional[Callable] = None, rng_key=None,
                aux_acc=None):
        """Full causal forward of (B, S, d). ``attn`` replaces the
        attention functional (same signature as
        ``scaled_dot_product_attention``); default the port's sdpa.
        ``rng_key`` (the layer's key) draws the dropout masks; an MoE
        layer appends its aux loss to ``aux_acc``."""
        b, s, d = x.shape
        q, k, v = self._qkv(x, torch.zeros((b,), dtype=torch.int64,
                                           device=x.device), w)
        attn_fn = attn or scaled_dot_product_attention
        a = attn_fn(q, k, v, is_causal=True)
        return self._block_tail(x, a.reshape(b, s, d).to(x.dtype), w,
                                rng_key, aux_acc)

    # -- cached decode (gpt.py:323-430 of the JAX package) ---------------

    def _write_kv_rows(self, kv, k, v, rows: CacheRows):
        """Write each row's K new KV entries ((B, K, Hkv, D), any dtype)
        into the head-major caches at ``rows``, in place. Returns the
        caches."""
        for cache, new in zip(kv, (k, v)):
            new = new.to(cache.dtype)
            if rows.write is not None:
                new = torch.where(rows.write[:, None, None, None], new,
                                  cache[rows.bi, :, rows.t, :])
            cache[rows.bi, :, rows.t, :] = new
        return kv

    def decode_rows(self, x, w, kv, positions):
        """K-token ragged decode that does NOT write the cache.

        x: (B, K, d) embeddings at positions [positions[b],
        positions[b] + K); kv: head-major (B, Hkv, T, D) caches holding
        each row's prefix [0, positions[b]) (later entries are ignored).
        Row (b, j) attends to the prefix plus new rows i <= j through a
        grouped einsum that reads the whole T. Returns (y, k_rows,
        v_rows), the rows (B, K, Hkv, D) in cache dtype for the caller
        to write."""
        b, K, d = x.shape
        k_cache, v_cache = kv
        T = k_cache.shape[2]
        q, k, v = self._qkv(x, positions, w)
        # the new rows round-trip through the cache dtype before they
        # enter attention: row i < j looks to row j as it will to a
        # later step reading it from the cache
        k = k.to(k_cache.dtype)
        v = v.to(v_cache.dtype)
        scale = 1.0 / math.sqrt(self.head_dim)
        group = self.n_heads // self.kv_heads
        # GQA through a grouped einsum against the un-expanded cache
        ct = torch.promote_types(q.dtype, k_cache.dtype)
        qg = q.reshape(b, K, self.kv_heads, group, self.head_dim)
        att = torch.einsum("bkhgd,bhtd->bhgkt", qg.to(ct),
                           k_cache.to(ct)) * scale
        k_pos = torch.arange(T, device=x.device)
        seen = k_pos[None, :] < positions.long()[:, None]
        att = att.float().masked_fill(~seen[:, None, None, None, :],
                                      float("-inf"))
        # the K new rows attend to each other causally
        nt = torch.promote_types(q.dtype, k.dtype)
        att_new = torch.einsum("bkhgd,bihd->bhgki", qg.to(nt),
                               k.to(nt)) * scale
        causal = torch.ones((K, K), dtype=torch.bool,
                            device=x.device).tril()
        att_new = att_new.float().masked_fill(~causal, float("-inf"))
        full = torch.softmax(torch.cat([att, att_new], dim=-1), dim=-1)
        # probabilities stay in the compute dtype
        p_cache = full[..., :T].to(x.dtype)
        p_new = full[..., T:].to(x.dtype)
        vt = torch.promote_types(x.dtype, v_cache.dtype)
        attn = (torch.einsum("bhgkt,bhtd->bkhgd", p_cache.to(vt),
                             v_cache.to(vt))
                + torch.einsum("bhgki,bihd->bkhgd", p_new.to(vt),
                               v.to(vt)))
        attn = attn.reshape(b, K, d).to(x.dtype)
        return self._block_tail(x, attn, w), k, v

    def verify_step(self, x, w, kv, rows: CacheRows):
        """K-token decode at ragged per-row positions that writes the
        rows into the caches: ``decode_rows`` plus the write."""
        y, k_rows, v_rows = self.decode_rows(x, w, kv, rows.positions)
        return y, self._write_kv_rows(kv, k_rows, v_rows, rows)

    def decode_step(self, x, w, kv, rows: CacheRows):
        """One-token ragged decode: when ``_use_decode_kernel``, K10
        writes the fresh row at ``rows.lengths - 1`` (where ``rows.write``
        holds) and attends over [0, positions + 1) in one launch; else
        ``verify_step``."""
        if not _use_decode_kernel(kv[0].shape[2]):
            return self.verify_step(x, w, kv, rows)
        b, _, d = x.shape
        k_cache, v_cache = kv
        q, k, v = self._qkv(x, rows.positions, w)
        dt = k_cache.dtype
        attn = decode_attention(
            q[:, 0].to(dt).contiguous(), k_cache, v_cache, rows.lengths,
            scale=1.0 / math.sqrt(self.head_dim),
            k_new=k[:, 0].to(dt).contiguous(),
            v_new=v[:, 0].to(dt).contiguous(), write=rows.write)
        attn = attn.to(x.dtype).reshape(b, 1, d)
        return self._block_tail(x, attn, w), (k_cache, v_cache)


class _Params(nn.Module):
    """A module holding given tensors as trainable parameters: one
    layer of an MoE stack (``blocks.item_<i>``), or its experts
    (``.moe``)."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        super().__init__()
        for n, t in tensors.items():
            self.register_parameter(n, nn.Parameter(t.detach()))


class GPT(nn.Module):
    """Decoder-only LM with learned positions (or rope), tied or untied
    head. ``GPT(cfg, seed)`` draws random weights from a seeded
    ``torch.Generator`` on ``device``; ``weights`` builds it from given
    tensors instead (``models/convert.py``): name -> tensor, the JAX
    head names plus, for a dense stack, (L, ...) slabs under the block
    names, for an MoE stack the per-layer JAX names
    (``layer_param_specs``). Every parameter is trainable: the head
    ones under their JAX names, a dense stack's slabs as
    ``stacked.<block name>``, an MoE stack's layers under their JAX
    names (``blocks.item_<i>.<name>``, the keys of the JAX
    ``split_params()``)."""

    def __init__(self, cfg: GPTConfig, seed: int = 0, device=None,
                 weights: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        if cfg.moe_experts > 0 and cfg.moe_every < 1:
            raise ValueError(f"moe_every must be >= 1, got "
                             f"{cfg.moe_every}")
        if cfg.moe_experts > 0 and cfg.remat:
            raise ValueError("moe_experts with remat is unsupported (the "
                             "aux-loss accumulator cannot cross a "
                             "checkpoint boundary)")
        dev = device_lib.resolve(device)
        self.cfg = cfg
        L = cfg.n_layers
        per_layer = cfg.moe_experts > 0
        blocks = layer_param_specs(cfg) if per_layer else {
            n: ((L, *s), dt, init)
            for n, (s, dt, init) in block_param_specs(cfg).items()}
        if weights is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
            weights = {n: draw_param(s, dt, init, gen, dev)
                       for n, (s, dt, init) in head_param_specs(cfg).items()}
            weights.update({n: draw_param(s, dt, init, gen, dev)
                            for n, (s, dt, init) in blocks.items()})
        self.wpe = self.lm_head = None
        # int8 weights (quantization.quantize_for_inference): a
        # QuantTensor for a head weight, a list of per-layer QuantTensors
        # for a block slab; they are not parameters
        self.quantized = {n: w for n, w in weights.items()
                          if not isinstance(w, torch.Tensor)}
        for n in head_param_specs(cfg):
            if n not in self.quantized:
                setattr(self, n, nn.Parameter(weights[n].detach()))
        self.stacked = nn.ParameterDict({
            n: nn.Parameter(weights[n].detach())
            for n in block_param_specs(cfg)
            if not per_layer and n not in self.quantized})
        self.blocks = None
        if per_layer:
            if self.quantized:
                raise NotImplementedError("an MoE stack takes no int8 "
                                          "weights")
            self.blocks = nn.Module()
            for i in range(L):
                own = {n.split(".", 2)[2]: weights[n] for n in blocks
                       if n.startswith(f"blocks.item_{i}.")}
                item = _Params({n: t for n, t in own.items()
                                if not n.startswith("moe.")})
                if is_moe_layer(cfg, i):
                    item.moe = _Params({n[4:]: t for n, t in own.items()
                                        if n.startswith("moe.")})
                self.blocks.add_module(f"item_{i}", item)
        self.block = GPTBlock(cfg)

    def slab_entries(self):
        """The parameter names of the stacked (L, ...) slabs
        (``stacked.<block name>``), as ``named_parameters`` gives them;
        none for an MoE stack."""
        return [f"stacked.{n}" for n in self.stacked]

    def layer_weights(self):
        """Per-layer name -> tensor maps: an MoE stack's layer
        parameters (the experts' as a map under ``"moe"``); else one
        ``unbind(0)`` per slab (views of the slabs, differentiable),
        with the quantized block weights' per-layer QuantTensors in
        their places."""
        if self.blocks is not None:
            layers = []
            for item in self.blocks.children():
                w = dict(item.named_parameters(recurse=False))
                if hasattr(item, "moe"):
                    w["moe"] = dict(item.moe.named_parameters())
                layers.append(w)
            return layers
        names = list(self.stacked.keys())
        layers = [dict(zip(names, ts)) for ts in
                  zip(*(self.stacked[n].unbind(0) for n in names))]
        if not names:
            layers = [{} for _ in range(self.cfg.n_layers)]
        for n, per_layer in self.quantized.items():
            if n in block_param_specs(self.cfg):
                for w, qt in zip(layers, per_layer):
                    w[n] = qt
        return layers

    def head_weight(self):
        """The LM projection (d, V), chosen here only: the tied ``wte``
        transposed, or the untied ``lm_head`` (its QuantTensor in an
        int8 model)."""
        if self.cfg.tie_embeddings:
            return self.wte.t()
        return self.quantized.get("lm_head", self.lm_head)

    def embed(self, tokens):
        x = self.wte[tokens]
        if self.wpe is not None:
            x = x + self.wpe[:tokens.shape[-1]]
        return x

    def head(self, x):
        x = final_ln(x, self.lnf_scale, self.lnf_bias)
        return x @ self.head_weight()

    def hidden_states(self, tokens, attn: Optional[Callable] = None,
                      rng_key=None, aux_acc=None):
        """Final hidden states (B, S, d): forward minus the LM head. With
        ``cfg.remat`` each block is recomputed in the backward
        (``jax.checkpoint`` per block in the JAX package), its dropout
        masks redrawn from the same key. Layer i's key is
        ``fold_in(rng_key, i)``; no key, no dropout. Each MoE layer
        appends its aux loss to ``aux_acc`` (an MoE stack has no
        remat)."""
        x = self.embed(tokens)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for i, w in enumerate(self.layer_weights()):
            k = prng.fold_in(rng_key, i) if rng_key is not None else None
            if remat:
                x = checkpoint(self.block, x, w, attn, k,
                               use_reentrant=False)
            else:
                x = self.block(x, w, attn, k, aux_acc)
        return x

    def logits_and_aux(self, tokens, attn: Optional[Callable] = None,
                       rng_key=None):
        """(logits (B, S, V), the summed MoE aux loss (fp32; zero for a
        dense stack)), differentiable."""
        aux_acc = []
        logits = self.head(self.hidden_states(tokens, attn, rng_key,
                                              aux_acc))
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
        for a in aux_acc:
            aux = aux + a
        return logits, aux

    @torch.no_grad()
    def forward(self, tokens, attn: Optional[Callable] = None,
                rng_key=None, return_aux: bool = False):
        """(B, S) int tokens → (B, S, V) logits in the model dtype; with
        ``return_aux``, (logits, the summed MoE aux loss)."""
        if return_aux:
            return self.logits_and_aux(tokens, attn, rng_key)
        return self.head(self.hidden_states(tokens, attn, rng_key))

    # -- KV-cache decoding (gpt.py:680-712 of the JAX package) -----------

    def init_cache(self, batch: int, max_len: Optional[int] = None,
                   dtype=None):
        """Per-layer (k, v) caches, head-major (B, Hkv, T, D) each, zeros
        on the model's device."""
        cfg = self.cfg
        T = max_len or cfg.max_seq_len
        dt = dtypes.to_dtype(dtype) if dtype is not None else cfg.dtype
        shape = (batch, cfg.kv_heads, T, cfg.head_dim)
        dev = self.wte.device
        return [(torch.zeros(shape, dtype=dt, device=dev),
                 torch.zeros(shape, dtype=dt, device=dev))
                for _ in range(cfg.n_layers)]

    def embed_at(self, tokens, pos: int):
        """Embedding of a chunk (B, L) starting at position ``pos``."""
        x = self.wte[tokens.long()]
        if self.wpe is None:
            return x
        return x + self.wpe[pos:pos + tokens.shape[-1]]

    @torch.no_grad()
    def forward_cached(self, tokens, cache, pos: int):
        """(B, L) tokens at positions [pos, pos + L) -> (logits, cache):
        the caches (``init_cache``) are written in place and returned."""
        return _cached_forward(self, self.layer_weights(), tokens, cache,
                               pos), cache


# ---------------------------------------------------------------------------
# Sampling and generation (counterparts of gpt.py:715-775, :887-930)
# ---------------------------------------------------------------------------

def _filter_logits(logits, temperature: float, top_p: float, top_k: int):
    """Temperature, then top-k, then nucleus (top-p) filtering of (B, V)
    fp32 logits: dropped entries become -inf. The same kept set as the
    JAX ``_sample_token``: top-k keeps logits >= the k-th largest; top-p
    keeps the smallest prefix of the sorted distribution whose mass
    reaches top_p (the first token crossing it included); a top_k past
    V keeps every logit."""
    logits = logits / temperature
    if top_k > 0:
        # a k past the vocab keeps every logit, as the JAX index clamps
        k = min(top_k, logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_l, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p
        cutoff = torch.where(keep, sorted_l,
                             torch.full_like(sorted_l, float("inf"))
                             ).amin(dim=-1)
        logits = logits.masked_fill(logits < cutoff[:, None],
                                    float("-inf"))
    return logits


def _sample_token(logits, generator: Optional[torch.Generator],
                  temperature: float, top_p: float, top_k: int):
    """Greedy (temperature 0) or temperature / top-k / top-p sampling of
    (B, V) fp32 logits -> (B,) int32, drawn from ``generator`` on the
    logits' device. A draw is argmax(p / E) with E ~ Exp(1), which picks
    token i with probability p_i and needs no host synchronisation; the
    JAX package draws with ``jax.random.categorical``, so the two agree
    in distribution, not draw for draw."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(_filter_logits(logits, temperature, top_p,
                                         top_k), dim=-1)
    noise = torch.empty_like(probs).exponential_(generator=generator)
    return torch.argmax(probs / noise, dim=-1).to(torch.int32)


def _cached_forward(m: "GPT", layers, tokens, caches, pos: int):
    """Logits of (B, L) tokens at [pos, pos + L) through per-layer
    (k, v) caches, written in place: one ``decode_step`` per layer for
    one token, ``verify_step`` for more, the rows' indices built once."""
    x = m.embed_at(tokens, pos)
    b, n = tokens.shape
    positions = torch.full((b,), int(pos), dtype=torch.int32,
                           device=tokens.device)
    rows = cache_rows(positions, n, caches[0][0].shape[2])
    step = m.block.decode_step if n == 1 else m.block.verify_step
    for w, kv in zip(layers, caches):
        x, _ = step(x, w, kv, rows)
    return m.head(x)


def _generate_scan(m: "GPT", b, s0, T, max_new_tokens, temperature, top_p,
                   top_k, eos_id, tokens, generator):
    """The dense stack's generation loop: the prompt, then each new
    token, through ``_cached_forward``."""
    layers = m.layer_weights()
    caches = m.init_cache(b, T)
    logits = _cached_forward(m, layers, tokens, caches, 0)
    nxt = _sample_token(logits[:, -1].float(), generator, temperature,
                        top_p, top_k)
    done = (torch.zeros((b,), dtype=torch.bool, device=tokens.device)
            if eos_id is None else nxt == eos_id)
    out = [nxt]
    for pos in range(s0, s0 + max_new_tokens - 1):
        logits = _cached_forward(m, layers, out[-1][:, None], caches, pos)
        nx = _sample_token(logits[:, -1].float(), generator, temperature,
                           top_p, top_k)
        if eos_id is not None:
            nx = torch.where(done, torch.full_like(nx, eos_id), nx)
            done = done | (nx == eos_id)
        out.append(nx)
    return torch.cat([tokens.to(torch.int32), torch.stack(out, dim=1)],
                     dim=1)


@torch.no_grad()
def generate(model: GPT, tokens, max_new_tokens: int,
             temperature: float = 0.0, top_p: float = 1.0, top_k: int = 0,
             eos_id: Optional[int] = None,
             generator: Optional[torch.Generator] = None,
             max_len: Optional[int] = None):
    """Autoregressive generation with a KV cache of length ``max_len``
    (default ``max_seq_len``). tokens: (B, S0) prompt (tensor or
    array). Returns (B, S0 + max_new_tokens) int32 on the model's
    device; after eos (if given) a row is padded with eos. Greedy by
    default; temperature / top-k / top-p sampling draws from
    ``generator`` (default: a fresh one seeded 0 on the model's
    device)."""
    cfg = model.cfg
    dev = model.wte.device
    tokens = torch.as_tensor(tokens).to(device=dev, dtype=torch.int64)
    b, s0 = tokens.shape
    T = max_len or cfg.max_seq_len
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got "
                         f"{max_new_tokens}")
    if s0 + max_new_tokens > T:
        raise ValueError(f"{s0 + max_new_tokens} tokens exceed cache "
                         f"length {T}")
    if T > cfg.max_seq_len and not cfg.rope:
        raise ValueError(f"cache length {T} exceeds the position table "
                         f"({cfg.max_seq_len})")
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    return _generate_scan(model, b, s0, T, max_new_tokens, temperature,
                          top_p, top_k, eos_id, tokens, generator)


GPT.generate = generate


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


def _maybe_dropout(x, p, key, salt):
    """Residual dropout as the JAX package draws it: keep =
    ``bernoulli(fold_in(key, salt), 1 - p, x.shape)`` (on x's device),
    kept entries divided by 1 - p in x's dtype."""
    if p == 0.0 or key is None:
        return x
    keep = prng.bernoulli(prng.fold_in(key, salt), 1.0 - p, x.shape,
                          device=x.device)
    scale = torch.tensor(1.0 - p, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / scale, 0.0).to(x.dtype)


def _use_fused_ce(cfg) -> bool:
    """Where the JAX package routes the train loss through the fused CE:
    a dense stack whose vocab has a 128-multiple block divisor, that is
    a vocab that is a multiple of 128 (the port has no kernel flag and
    no multi-device mesh; its kernels mask a ragged vocab tile, so the
    rule only keeps the two packages on the same loss path)."""
    return cfg.moe_experts == 0 and cfg.vocab_size % 128 == 0


def fused_lm_loss(m: GPT, tokens, attn: Optional[Callable] = None,
                  ce: Optional[Callable] = None, rng_key=None):
    """Causal LM loss with head-LN + LM projection + softmax-CE fused
    (K5-K7 on the card), so the (B, S, V) logits never exist in device
    memory; ``forward`` + ``lm_loss`` where the fused CE does not apply.
    ``attn`` replaces the attention functional, ``ce`` the fused CE
    (same signature as ``fused_softmax_cross_entropy``); ``rng_key``
    draws the dropout masks."""
    if not _use_fused_ce(m.cfg):
        return lm_loss(m.head(m.hidden_states(tokens, attn, rng_key)),
                       tokens)
    x = m.hidden_states(tokens, attn, rng_key)
    b, s, d = x.shape
    xn = final_ln(x, m.lnf_scale, m.lnf_bias)
    w = m.head_weight()
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError("an int8 model serves; it does not "
                                  "train")
    w = w.t()   # (V, d)
    rows = xn[:, :-1].reshape(b * (s - 1), d)
    labels = tokens[:, 1:].reshape(-1)
    per_tok = (ce or fused_softmax_cross_entropy)(rows, w, labels)
    return per_tok.sum() / (b * (s - 1))


def register_slab_decay_masks(optimizer, slabs, n_layers: int, name_of):
    """Resolve ``optimizer.apply_decay_param_fun`` once per layer under
    the JAX per-layer names (``name_of(i, name)``) into an (L, 1, ...)
    fp32 0/1 mask per slab on the slab's device, and register each
    under its entry name with the optimizer's ``set_decay_mask``.
    ``slabs`` maps entry name -> (block parameter name, slab). A
    decision that varies by layer is kept (one row per layer). Shared by
    the GPT and BERT stacked layouts."""
    decay_fn = optimizer.apply_decay_param_fun
    set_mask = getattr(optimizer, "set_decay_mask", None)
    if set_mask is None:
        raise ValueError(
            f"optimizer {type(optimizer).__name__} sets "
            "apply_decay_param_fun but has no set_decay_mask(); the "
            "stacked layout needs the masked update path "
            "(paddle_tpu_torch.optimizer.AdamW)")
    for entry, (name, slab) in slabs.items():
        col = [float(bool(decay_fn(name_of(i, name))))
               for i in range(n_layers)]
        set_mask(entry, torch.tensor(
            col, dtype=torch.float32, device=slab.device).reshape(
                (n_layers,) + (1,) * (slab.dim() - 1)))


def register_stacked_decay_mask(optimizer, model: GPT):
    """``register_slab_decay_masks`` over the GPT slabs
    (``stacked.<name>``) under the names ``blocks.item_<i>.<name>``."""
    register_slab_decay_masks(
        optimizer, {e: (n, t) for e, (n, t) in zip(
            model.slab_entries(), model.stacked.items())},
        model.cfg.n_layers, lambda i, name: f"blocks.item_{i}.{name}")


def init_train_state(model: GPT, optimizer):
    """``(params, opt_state)``: the model's own parameters by name and the
    optimizer's state. A dense stack's slabs are stacked, as the JAX
    ``stacked=True`` state: an ``apply_decay_param_fun`` is resolved
    against the per-layer names into masks over the slabs
    (``register_stacked_decay_mask``), as the JAX stacked state does. An
    MoE stack's state is per layer, as the JAX default
    ``stacked=False`` state: the names are the per-layer ones, and the
    optimizer resolves ``apply_decay_param_fun`` on each entry."""
    if (getattr(optimizer, "apply_decay_param_fun", None) is not None
            and model.slab_entries()):
        register_stacked_decay_mask(optimizer, model)
    params = dict(model.named_parameters())
    return params, optimizer.init(params)


def train_loss(m: GPT, tokens, attn: Optional[Callable] = None,
               ce: Optional[Callable] = None, rng_key=None):
    """The train step's loss: ``fused_lm_loss``; for an MoE stack, as the
    JAX step (``paddle_tpu/models/gpt.py:1160-1164``), ``lm_loss`` of the
    full logits plus ``moe_aux_weight`` times the summed aux loss (the
    MoE's jitter, with the dropout, drawn from ``rng_key``)."""
    if m.cfg.moe_experts > 0:
        logits, aux = m.logits_and_aux(tokens, attn, rng_key)
        return lm_loss(logits, tokens) + m.cfg.moe_aux_weight * aux
    return fused_lm_loss(m, tokens, attn, ce, rng_key=rng_key)


def check_step_params(own, params, optimizer, slabs):
    """A train step's preamble: ``params`` must be the model's own
    parameter dict (``own``), and with ``apply_decay_param_fun`` set
    every slab in ``slabs`` needs its registered decay mask. Clears the
    gradients."""
    if params.keys() != own.keys() or any(
            params[n] is not p for n, p in own.items()):
        raise ValueError("params must be the model's own parameter "
                         "dict (init_train_state)")
    if getattr(optimizer, "apply_decay_param_fun", None) is not None:
        bare = [n for n in slabs if optimizer.decay_mask(n) is None]
        if bare:
            raise ValueError(
                f"apply_decay_param_fun is set but the stacked slabs "
                f"{bare} have no registered decay mask; resolve one "
                f"per layer first (init_train_state does this)")
    for p in own.values():
        p.grad = None


def finish_step(own, slabs, optimizer, params, opt_state, loss, num_on,
                num_box):
    """A train step's tail: backward of ``loss``, the gradients through
    the ``train.grad_poison`` site, the optimizer update in place, and
    with ``num_on`` the packed numerics vector as a 4th output."""
    loss.backward()
    count = opt_state["step"]
    grads = numerics.poison_grads({n: p.grad for n, p in own.items()},
                                  slabs, step_count=count)
    sampled = num_on and numerics.due(count)
    old = ({n: p.detach().clone() for n, p in own.items()}
           if sampled else None)
    params, opt_state = optimizer.update(grads, opt_state, params)
    loss = loss.detach()
    if not num_on:
        return params, opt_state, loss
    updates = ({n: p.detach() - old[n] for n, p in own.items()}
               if sampled else None)
    packed = numerics.capture_step(grads, loss=loss, updates=updates,
                                   step_count=count, stacked_keys=slabs,
                                   box=num_box)
    return params, opt_state, loss, packed


def build_train_step(model: GPT, optimizer,
                     attn: Optional[Callable] = None,
                     ce: Optional[Callable] = None):
    """``step(params, opt_state, tokens, rng=None) -> (params, opt_state,
    loss)``: forward, ``train_loss`` (dropout drawn from ``rng``, a
    ``paddle_tpu_torch.random`` key, when the config has it), backward,
    optimizer update. ``params`` is the dict ``init_train_state``
    returned; the step trains the model in place (the new parameters are
    the same tensors) and leaves this step's gradients in each
    parameter's ``.grad``. ``attn`` and ``ce`` replace the attention and
    the fused CE (the plain versions, to hold the kernels against).

    With ``PT_NUMERICS_EVERY`` > 0 when the step is built, it returns a
    4th output, the packed numerics vector (per-layer gradient and
    update statistics and the NaN provenance header,
    ``observability.numerics.capture_step``), and ``step.numerics_layout``
    decodes it. The gradients pass the ``train.grad_poison`` fault site
    before the update.

    With ``apply_decay_param_fun`` set, every slab needs the mask
    ``init_train_state`` registers: the name fn cannot see into a slab,
    and without a mask it would decay the LayerNorm scales and biases
    that the per-layer names exempt, so the step raises."""
    own = dict(model.named_parameters())
    slabs = model.slab_entries()
    num_on = numerics.enabled()
    num_box = numerics.LayoutBox()

    def step(params, opt_state, tokens, rng=None):
        check_step_params(own, params, optimizer, slabs)
        loss = train_loss(model, tokens, attn, ce, rng_key=rng)
        return finish_step(own, slabs, optimizer, params, opt_state, loss,
                           num_on, num_box)

    step.numerics_layout = num_box
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
