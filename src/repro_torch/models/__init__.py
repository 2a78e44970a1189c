"""Model families (port of ``repro.models``): the recsys architectures
and the sharding hints they use. The LM (transformer, MoE) and GNN
families are not ported yet (ROADMAP item 11)."""
from .recsys import (BST, DCN, DLRM, BSTConfig, DCNConfig, DLRMConfig,
                     RecsysModel, TwoTower, TwoTowerConfig, bst_logits,
                     bst_loss, dcn_logits, dcn_loss, dlrm_logits, dlrm_loss,
                     embedding_bag, embedding_lookup, init_twotower_params,
                     retrieval_scores, retrieval_topk, twotower_loss,
                     unified_table_offsets)
from .sharding import DP, shard_hint

__all__ = [
    "BST", "DCN", "DLRM", "TwoTower", "RecsysModel", "BSTConfig",
    "DCNConfig", "DLRMConfig", "TwoTowerConfig", "bst_logits", "bst_loss",
    "dcn_logits", "dcn_loss", "dlrm_logits", "dlrm_loss", "embedding_bag",
    "embedding_lookup", "init_twotower_params", "retrieval_scores",
    "retrieval_topk", "twotower_loss", "unified_table_offsets", "DP",
    "shard_hint",
]
