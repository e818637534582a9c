"""The scenario mesh across processes and cards: the shard plan
(``sharding``), ``torch.distributed`` set-up and launch (``distributed``),
and the host merge and compressed all-reduce (``collectives``)."""
from repro_torch.parallel.sharding import ScenarioShardPlan, scenario_plan

__all__ = ["ScenarioShardPlan", "scenario_plan"]
