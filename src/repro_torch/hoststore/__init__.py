"""Out-of-core sampled training: host-resident temporal graph store +
fanout-sampled snapshot streaming (port of ``repro.hoststore``).

The full-graph schedules bound N by device memory — every round
materializes full per-snapshot tensors on the device.  This package keeps
the trace host-resident instead and streams only sampled, static-shape
subgraphs:

* :mod:`~repro_torch.hoststore.store`  — ``TemporalCSRStore``: per-step
  CSR adjacency on host numpy, ingested incrementally from the SAME
  ``IncrementalEncoder`` delta items the device path uses;
* :mod:`~repro_torch.hoststore.sampled` — ``SampledSliceStream``:
  per-round seed batches, ``graph/sampler.py`` fanout expansion in host
  worker threads, fixed-size padded subgraph tensors, the rank's time
  slice staged through the prefetch machinery;
* :mod:`~repro_torch.hoststore.carry`  — ``HostCarryStore``: per-node
  temporal state host-resident between rounds, gathered/scattered by
  table rows;
* :mod:`~repro_torch.hoststore.train`  — ``train_sampled``: the
  ``mode="sampled"`` driver (the distributed round step on the table
  axis, one process per rank);
* :mod:`~repro_torch.hoststore.budget` — the simulated per-device
  graph-byte budget that full-graph schedules refuse and sampling fits.
"""

from repro_torch.hoststore.budget import (DeviceBudgetError, check_budget,
                                          full_graph_round_bytes,
                                          sampled_round_bytes)
from repro_torch.hoststore.carry import HostCarryStore
from repro_torch.hoststore.sampled import (SampledSliceStream, SampleReport,
                                           SampleRound, StagedRound,
                                           draw_seeds, sample_round)
from repro_torch.hoststore.spec import ResolvedSampling, SamplingSpec
from repro_torch.hoststore.store import TemporalCSRStore
from repro_torch.hoststore.train import (SampledState, make_sampled_step,
                                         table_config, train_sampled)

__all__ = [
    "DeviceBudgetError", "check_budget", "full_graph_round_bytes",
    "sampled_round_bytes", "HostCarryStore", "SampledSliceStream",
    "SampleReport", "SampleRound", "StagedRound", "draw_seeds",
    "sample_round", "ResolvedSampling", "SamplingSpec",
    "TemporalCSRStore", "SampledState", "make_sampled_step",
    "table_config", "train_sampled",
]
