from .hits import EdgeList, hits_sweep, hits_sweep_cols
from .reordering import blocking_permutation
from .weights import accel_weights

__all__ = ["EdgeList", "hits_sweep", "hits_sweep_cols",
           "blocking_permutation", "accel_weights"]
