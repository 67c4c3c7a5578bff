"""ERNIE 3.0 family (counterpart of ``paddle_tpu/models/ernie.py``): the
BERT trunk of ``models/bert.py`` plus a task-type embedding plane, added
to the token, position and segment sum before the embedding LayerNorm
(through ``Bert.forward``'s ``extra_embed``).

``ErnieForSequenceClassification`` is the BERT classifier head over an
``Ernie`` trunk; as in JAX, the trunk the head built is re-homed under
``ernie.bert``, so the parameter names are the JAX ``split_params()``
names (``ernie.bert.*``, ``ernie.wtask``, ``cls_w``, ``cls_b``).
"""

from dataclasses import dataclass

import torch.nn.functional as torch_F
from torch import nn

from paddle_tpu_torch import device as device_lib
from paddle_tpu_torch.incubate.moe import draw_param
from paddle_tpu_torch.models.bert import (Bert, BertConfig,
                                          BertForSequenceClassification,
                                          _generator)

__all__ = ["ErnieConfig", "Ernie", "ErnieForSequenceClassification",
           "ernie3_base", "ernie3_medium", "ernie3_micro"]


@dataclass(frozen=True)
class ErnieConfig(BertConfig):
    vocab_size: int = 40000
    task_type_vocab_size: int = 3


class Ernie(nn.Module):
    """ERNIE trunk: a ``Bert`` trunk (``trunk``, or a new one) and the
    task-type embedding ``wtask``."""

    def __init__(self, cfg: ErnieConfig, seed: int = 0, device=None,
                 trunk=None):
        super().__init__()
        dev = device_lib.resolve(device)
        self.cfg = cfg
        self.bert = trunk if trunk is not None else Bert(cfg, seed, dev)
        self.wtask = nn.Parameter(draw_param(
            (cfg.task_type_vocab_size, cfg.d_model), cfg.dtype, 0.02,
            _generator(dev, seed, 777), dev))

    def forward(self, tokens, token_type_ids=None, task_type_ids=None,
                attention_mask=None, rng_key=None, attn=None):
        task = (torch_F.embedding(task_type_ids, self.wtask)
                if task_type_ids is not None else self.wtask[0])
        return self.bert(tokens, token_type_ids, attention_mask, rng_key,
                         extra_embed=task, attn=attn)


class ErnieForSequenceClassification(BertForSequenceClassification):
    """The fine-tune configuration: the BERT classifier head over the
    ERNIE trunk."""

    def __init__(self, cfg: ErnieConfig, num_classes: int = 2,
                 seed: int = 0, device=None):
        super().__init__(cfg, num_classes, seed, device)
        trunk = self.bert
        del self.bert
        self.ernie = Ernie(cfg, seed, trunk.wte.device, trunk=trunk)

    def forward(self, tokens, token_type_ids=None, task_type_ids=None,
                attention_mask=None, rng_key=None, attn=None):
        _, pooled = self.ernie(tokens, token_type_ids, task_type_ids,
                               attention_mask, rng_key, attn=attn)
        return pooled @ self.cls_w + self.cls_b


def ernie3_base(**kw):
    # the released ernie-3.0-base config: 2048 positions, 4 segment types
    d = dict(d_model=768, n_layers=12, n_heads=12, max_position=2048,
             type_vocab_size=4)
    d.update(kw)
    return ErnieConfig(**d)


def ernie3_medium(**kw):
    d = dict(d_model=768, n_layers=6, n_heads=12, max_position=2048,
             type_vocab_size=4)
    d.update(kw)
    return ErnieConfig(**d)


def ernie3_micro(**kw):
    d = dict(vocab_size=1024, max_position=64, d_model=64, n_layers=2,
             n_heads=2, dropout=0.0, dtype="float32")
    d.update(kw)
    return ErnieConfig(**d)
