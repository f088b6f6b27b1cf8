"""Wide&Deep CTR, the local network: BASELINE config 4's model.

Counterpart of ``paddle_tpu/models/wide_deep.py``, with the same
parameter names, shapes and defaults (a 100000 x 16 table, 26 sparse
slots, 13 dense features, fc 400-400-400). ``distributed_embedding=``
takes the table to use in place of the model's own, as there; built as
``nn.Embedding(100000, 16, sparse=True)`` it gives the table a sparse
gradient (``core/selected_rows.py``), which the eager optimizers apply to
the touched rows only. The parameter server that shards the table
(``DistributedEmbedding``) waits for ``ROADMAP.md`` A6.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from .. import nn
from ..nn import functional as F


class WideDeep(nn.Layer):
    def __init__(self, sparse_feature_number: int = 100000,
                 sparse_feature_dim: int = 16,
                 dense_feature_dim: int = 13,
                 num_sparse_slots: int = 26,
                 fc_sizes: Optional[List[int]] = None,
                 distributed_embedding=None, device=None):
        super().__init__(device)
        fc_sizes = fc_sizes or [400, 400, 400]
        self.num_sparse_slots = num_sparse_slots
        if distributed_embedding is not None:
            self.embedding = distributed_embedding
        else:
            self.embedding = nn.Embedding(sparse_feature_number,
                                          sparse_feature_dim, device=device)
        # the wide part: a linear map of the dense features
        self.wide = nn.Linear(dense_feature_dim, 1, device=device)
        # the deep part: an MLP over [dense ; the slots' embeddings]
        layers = []
        in_dim = dense_feature_dim + num_sparse_slots * sparse_feature_dim
        for size in fc_sizes:
            layers += [nn.Linear(in_dim, size, device=device), nn.ReLU()]
            in_dim = size
        layers.append(nn.Linear(in_dim, 1, device=device))
        self.deep = nn.Sequential(*layers)

    def forward(self, sparse_ids, dense_features):
        """sparse_ids: int [B, slots]; dense_features: [B, dense_dim]."""
        return self.forward_from_rows(self.embedding(sparse_ids),
                                      dense_features)

    def forward_from_rows(self, emb, dense_features):
        """The dense net from embedding rows already looked up ([B, slots,
        dim], what a parameter server's lookup returns)."""
        deep_in = torch.cat([dense_features, emb.reshape(emb.shape[0], -1)],
                            dim=1)
        return self.wide(dense_features) + self.deep(deep_in)

    def loss(self, logit, label):
        return F.binary_cross_entropy_with_logits(logit, label,
                                                  reduction="mean")
