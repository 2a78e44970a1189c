"""Model families (port of ``repro.models``): the LM family (the
decoder-only transformer with GQA, MLA, SWA and MoE, and its KV-cache
decode), the GNN (GIN, its aggregation on K3), the recsys architectures
and the sharding hints they use."""
from .gnn import GIN, GINConfig
from .recsys import (BST, DCN, DLRM, BSTConfig, DCNConfig, DLRMConfig,
                     RecsysModel, TwoTower, TwoTowerConfig, bst_logits,
                     bst_loss, dcn_logits, dcn_loss, dlrm_logits, dlrm_loss,
                     embedding_bag, embedding_lookup, init_twotower_params,
                     retrieval_scores, retrieval_topk, twotower_loss,
                     unified_table_offsets)
from .sharding import DP, shard_hint
from .transformer import (Transformer, TransformerConfig, decode_step,
                          forward, init_cache, init_params, loss_fn)

__all__ = [
    "Transformer", "TransformerConfig", "init_params", "forward", "loss_fn",
    "init_cache", "decode_step",
    "BST", "DCN", "DLRM", "TwoTower", "RecsysModel", "BSTConfig",
    "DCNConfig", "DLRMConfig", "TwoTowerConfig", "bst_logits", "bst_loss",
    "dcn_logits", "dcn_loss", "dlrm_logits", "dlrm_loss", "embedding_bag",
    "embedding_lookup", "init_twotower_params", "retrieval_scores",
    "retrieval_topk", "twotower_loss", "unified_table_offsets", "DP",
    "shard_hint", "GIN", "GINConfig",
]
