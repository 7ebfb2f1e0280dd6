"""Serving: paged BAM KV cache + continuous batching (port of
``repro.serving``).

* ``paged_cache`` — host ``PageTable`` + device page pool, decode-grid
  page compaction;
* ``model`` — ``paged_prefill`` and ``paged_decode_step`` (plain
  dense-gather or K4 attention);
* ``engine`` — ``ServingEngine``: queue, admission with up-front page
  budgets, prefill/decode interleaving, greedy streaming.
"""
from repro_torch.serving.engine import (InfeasibleRequest, Request,
                                        ServingEngine)
from repro_torch.serving.model import (check_serving_cfg, grid_window,
                                       paged_decode_step, paged_prefill,
                                       prefill_forward, static_layer_window)
from repro_torch.serving.paged_cache import (NULL_PAGE, DecodeGrid,
                                             PageTable, build_decode_grid,
                                             decode_grid_bucket,
                                             init_paged_cache)

__all__ = [
    "NULL_PAGE", "DecodeGrid", "InfeasibleRequest", "PageTable",
    "Request", "ServingEngine",
    "build_decode_grid", "check_serving_cfg", "decode_grid_bucket",
    "grid_window", "init_paged_cache", "paged_decode_step",
    "paged_prefill", "prefill_forward", "static_layer_window",
]
