"""Serving: paged KV-cache and the continuous-batching engine.

* :mod:`repro_torch.serving.kv_cache`: block-table pages, host allocator,
  device gather/scatter;
* :mod:`repro_torch.serving.engine`: request queue + iteration-level
  scheduler driving ``prefill_paged`` / ``decode_step_paged``.
"""

from repro_torch.serving.engine import AbortInfo, Engine, Request, ServeConfig
from repro_torch.serving.kv_cache import BlockPool, PagedLayout

__all__ = ["AbortInfo", "BlockPool", "Engine", "PagedLayout", "Request",
           "ServeConfig"]
