"""``repro_torch.serve`` — online inference on the card.

The port of ``repro.serve`` for the dyngnn and lm families.  For dyngnn,
live CTDG events ingest incrementally (``OnlineIngester`` -> the
graph-diff delta stream), one state-advance per closed window rolls the
temporal carries forward in place on the device, and queries are
micro-batched reads against the warm on-device embedding cache.  For lm,
``ServeEngine.generate`` runs prefill + greedy KV-cache decode, its decode
attention on the ``flash_decode`` kernel.

    from repro_torch.serve import IngestSpec, ServeConfig, ServeEngine

    eng = ServeEngine(ServeConfig(
        arch="paper_dyngnn",
        ingest=IngestSpec(num_windows=16, time_range=(0.0, 1.0))))
    eng.ingest(events)                 # live CTDG pushes
    eng.advance()                      # close a window, roll state
    scores = eng.query_nodes([3, 17])  # read resident state

    lm = ServeEngine(ServeConfig(arch="yi-6b", prompt_len=32,
                                 max_tokens=64))
    tokens = lm.generate(batch_size=8)   # (8, 64) greedy tokens
"""

from repro_torch.serve.batching import PendingQuery, QueryBatcher
from repro_torch.serve.config import IngestSpec, ServeConfig, ServeResult
from repro_torch.serve.engine import ServeEngine, serve
from repro_torch.serve.ingest import LateEventError, OnlineIngester
from repro_torch.serve.state import (fresh_carries, make_advance_step,
                                     make_link_query_step,
                                     make_node_query_step)

__all__ = [
    "IngestSpec", "LateEventError", "OnlineIngester", "PendingQuery",
    "QueryBatcher", "ServeConfig", "ServeEngine", "ServeResult",
    "fresh_carries", "make_advance_step", "make_link_query_step",
    "make_node_query_step", "serve",
]
