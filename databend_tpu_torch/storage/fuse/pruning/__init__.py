from .range_pruner import range_should_keep, PruneResult
from .pruner import FusePruner, PrunedBlock, PruningStats

__all__ = ["range_should_keep", "PruneResult", "FusePruner", "PrunedBlock", "PruningStats"]
