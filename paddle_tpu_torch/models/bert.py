"""BERT: BertModel, BertForPretraining (MLM + NSP heads), its
``pretraining_loss``, and BertForSequenceClassification.

Counterpart of ``paddle_tpu/models/bert.py``, with the same parameter
names, so ``jit.load_reference_state`` carries the JAX package's weights
across. Model constructors take ``device=None`` and resolve it through
``paddle_tpu_torch.device``: without a CUDA card they raise unless asked
for ``"cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .. import device as device_mod
from ..layers.helper import Normal, ParamAttr
from ..nn import functional as F
from ..nn.layer import Layer
from ..nn.layers_lib import Dropout, Embedding, LayerNorm, Linear
from ..nn.transformer import TransformerEncoder, TransformerEncoderLayer


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02


def bert_base_config() -> BertConfig:
    return BertConfig()


class BertEmbeddings(Layer):
    """word + position + token-type embeddings, layer norm, dropout."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__(device)
        init = ParamAttr(initializer=Normal(0.0, cfg.initializer_range))
        self.word_embeddings = Embedding(
            cfg.vocab_size, cfg.hidden_size, weight_attr=init, device=device)
        self.position_embeddings = Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, weight_attr=init,
            device=device)
        self.token_type_embeddings = Embedding(
            cfg.type_vocab_size, cfg.hidden_size, weight_attr=init,
            device=device)
        self.layer_norm = LayerNorm(cfg.hidden_size, epsilon=1e-12,
                                    device=device)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        seq = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(
                seq, device=input_ids.device).expand(input_ids.shape)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids) +
               self.position_embeddings(position_ids) +
               self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class BertPooler(Layer):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__(device)
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size, device=device)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return F.tanh(self.dense(hidden[:, 0]))


class BertModel(Layer):
    def __init__(self, cfg: Optional[BertConfig] = None, device=None):
        device = device_mod.resolve(device)
        super().__init__(device)
        self.cfg = cfg = cfg or bert_base_config()
        self.embeddings = BertEmbeddings(cfg, device=device)
        self.encoder = TransformerEncoder(
            lambda: TransformerEncoderLayer(
                cfg.hidden_size, cfg.num_attention_heads,
                cfg.intermediate_size, cfg.hidden_dropout_prob,
                cfg.hidden_act,
                attn_dropout=cfg.attention_probs_dropout_prob,
                device=device),
            cfg.num_hidden_layers)
        self.pooler = BertPooler(cfg, device=device)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        mask = None
        if attention_mask is not None:
            # [B, S] 1/0 -> additive fp32 [B, 1, 1, S]
            mask = ((1.0 - attention_mask.to(torch.float32))[:, None, None, :]
                    * torch.finfo(torch.float32).min)
        emb = self.embeddings(input_ids, token_type_ids)
        encoded = self.encoder(emb, mask)
        return encoded, self.pooler(encoded)


class BertLMHead(Layer):
    """MLM head whose decoder weight is the word-embedding matrix."""

    def __init__(self, cfg: BertConfig, embedding_weights: torch.nn.Parameter,
                 device=None):
        super().__init__(device)
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size,
                                device=device)
        self.layer_norm = LayerNorm(cfg.hidden_size, epsilon=1e-12,
                                    device=device)
        self.act = cfg.hidden_act
        self.decoder_weight = embedding_weights  # tied: the same Parameter
        self.decoder_bias = self.create_parameter([cfg.vocab_size],
                                                  is_bias=True)

    def forward(self, hidden: torch.Tensor,
                masked_positions: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if masked_positions is not None:
            # gather the masked positions before the vocab projection
            idx = masked_positions.long()[..., None].expand(
                -1, -1, hidden.shape[-1])
            hidden = torch.gather(hidden, 1, idx)
        h = self.layer_norm(getattr(F, self.act)(self.transform(hidden)))
        return F.matmul(h, self.decoder_weight, transpose_y=True) + \
            self.decoder_bias


class BertForPretraining(Layer):
    """MLM + NSP pretraining heads."""

    def __init__(self, cfg: Optional[BertConfig] = None, device=None):
        device = device_mod.resolve(device)
        super().__init__(device)
        self.bert = BertModel(cfg, device=device)
        cfg = self.bert.cfg
        self.cls = BertLMHead(cfg, self.bert.embeddings.word_embeddings
                              .weight, device=device)
        self.nsp = Linear(cfg.hidden_size, 2, device=device)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                masked_positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """masked_positions: optional [B, M] positions of the masked tokens;
        when given, the MLM logits are [B, M, vocab]."""
        encoded, pooled = self.bert(input_ids, token_type_ids,
                                    attention_mask)
        return self.cls(encoded, masked_positions), self.nsp(pooled)


def pretraining_loss(mlm_logits: torch.Tensor, nsp_logits: torch.Tensor,
                     mlm_labels: torch.Tensor,
                     nsp_labels: torch.Tensor) -> torch.Tensor:
    """Masked-LM loss (ignore_index=-100 for unmasked positions) plus the
    NSP loss, each the ``mean`` op over every position
    (``paddle_tpu/models/bert.py:pretraining_loss``)."""
    mlm = F.cross_entropy(mlm_logits, mlm_labels, ignore_index=-100,
                          reduction="mean")
    nsp = F.cross_entropy(nsp_logits, nsp_labels, reduction="mean")
    return mlm + nsp


class BertForSequenceClassification(Layer):
    """Finetune head: dropout + linear over the pooled output."""

    def __init__(self, cfg: Optional[BertConfig] = None,
                 num_classes: int = 2, dropout: Optional[float] = None,
                 device=None):
        device = device_mod.resolve(device)
        super().__init__(device)
        self.bert = BertModel(cfg, device=device)
        cfg = self.bert.cfg
        self.dropout = Dropout(
            cfg.hidden_dropout_prob if dropout is None else dropout)
        self.classifier = Linear(cfg.hidden_size, num_classes, device=device)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))
