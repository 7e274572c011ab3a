"""``repro_torch.run`` — the declarative training API of the port.

    from repro_torch.run import (Engine, ExecutionPlan, RunConfig,
                                 SyntheticTrace)

    run = RunConfig(
        model=DynGNNConfig(model="tmgcn", num_nodes=128, num_steps=16),
        data=SyntheticTrace(num_nodes=128, num_steps=16,
                            smoothing_mode="mproduct", window=3),
        plan=ExecutionPlan(mode="eager", num_steps=20), seed=0)
    result = Engine(run).fit()        # on the card; device="cpu" on a host

Port of ``repro.run``: ``eager`` (the blocked trainer of paper §3.1, on
one device or snapshot-partitioned over a process group, §4.2),
``streamed`` (per-snapshot training over the graph-difference delta
stream, §3.2), ``streamed_mesh`` (per-rank delta streams under
snapshot partitioning, §3.2 x §4.2) and ``sampled`` (out-of-core
fanout-sampled training over the host-resident store, with
``SamplingSpec``; ``device_budget_bytes`` gates every mode and raises
``DeviceBudgetError``).  ``CheckpointSpec`` checkpoints the eager and
streamed_mesh schedules (``Engine.resume()``), and the streamed_mesh
plan's ``rescale`` / ``rescale_on_preempt`` change its width mid-run
(``repro_torch.elastic``).
"""

from repro_torch.hoststore import (DeviceBudgetError, SampleReport,
                                   SamplingSpec)
from repro_torch.run.config import (CheckpointSpec, ResolvedRun, RunConfig,
                                    RunResult)
from repro_torch.run.data import (DataSource, InMemoryDTDG, SyntheticTrace,
                                  pad_dataset)
from repro_torch.run.engine import Engine
from repro_torch.run.plan import ExecutionPlan

__all__ = [
    "CheckpointSpec", "DataSource", "DeviceBudgetError", "Engine",
    "ExecutionPlan", "InMemoryDTDG", "ResolvedRun", "RunConfig",
    "RunResult", "SampleReport", "SamplingSpec", "SyntheticTrace",
    "pad_dataset",
]
