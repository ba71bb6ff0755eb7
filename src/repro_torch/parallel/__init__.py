"""The model-parallel layer: layouts from the reference's rule tables
(:mod:`.sharding`) and the counted collectives the layers issue on
local shards (:mod:`.collectives`)."""
from . import collectives, sharding
from .sharding import (ACT_RULES, PARAM_RULES, NamedSharding,
                       cache_axes_like, make_cst, param_shardings, spec_for)

__all__ = ["collectives", "sharding", "ACT_RULES", "PARAM_RULES",
           "NamedSharding", "cache_axes_like", "make_cst", "param_shardings",
           "spec_for"]
