from mpx_torch.ops.aggregates import (
    merge_aggregates,
    pearson_to_euclidean,
    postcompute,
)
from mpx_torch.ops.precompute import (
    host_statistics,
    precompute_statistics,
    precompute_statistics_numpy,
    stats_from_numpy,
)

__all__ = [
    "host_statistics",
    "precompute_statistics",
    "precompute_statistics_numpy",
    "stats_from_numpy",
    "merge_aggregates",
    "pearson_to_euclidean",
    "postcompute",
]
