from .hits import (EdgeList, accel_hits, authority_sweep, hits_sweep,
                   hits_sweep_cols, qi_hits, uniform_start)
from .power import PowerResult, power_method
from .reordering import blocking_permutation
from .weights import accel_weights

__all__ = ["EdgeList", "accel_hits", "authority_sweep", "hits_sweep",
           "hits_sweep_cols", "qi_hits", "uniform_start", "PowerResult",
           "power_method", "blocking_permutation", "accel_weights"]
