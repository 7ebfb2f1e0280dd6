"""Pipeline scheduling (the port's own copy of ``repro.core.schedule``):
stage graphs, a discrete-event simulator over F/B/W work items, four
schedulers behind one interface, and the memory-validation harness that
ties the simulator's activation model to the real executor.

* ``OneFOneB`` ("1f1b"): one stage per device, monolithic backward.
* ``Interleaved1F1B`` ("interleaved"): Megatron-LM virtual stages,
  device d hosting chunks {d, d+D, ...} of the layer chain.
* ``ZBH1`` ("zb-h1"): backward split into input-grad (B) and weight-grad
  (W) passes, W deferred into bubbles under 1F1B's activation cap.
  Frozen modules have no W at all (Cornstarch §4.2).
* ``ZBV`` ("zb-v"): 2p chunk-stages on p devices in a V, device i
  hosting chunks i and 2p-1-i, B/W split as in ZB-H1.

Every simulation returns its work-item timeline, stage->device map and
per-device peak live activations; ``core.schedule.memory`` replays that
timeline on ``core.modality_parallel.execute_schedule`` and fails loudly
if the measured peaks diverge from the simulated ones.
"""
from .graph import (PipelineGraph, Stage, chain_graph,  # noqa: F401
                    interleave_devices, refine_chain, v_shape_devices)
from .schedulers import (SCHEDULES, Interleaved1F1B,  # noqa: F401
                         OneFOneB, Scheduler, ZBH1, ZBV, get_scheduler,
                         simulate)
from .simulator import (item_id, peak_live_activations,  # noqa: F401
                        run_schedule, sort_items)
from .memory import (MemoryModelMismatch,  # noqa: F401
                     activation_caps, validate_schedule_memory)
