"""Dynamic-graph incremental recoloring (DESIGN.md §7; the port of the
reference's ``dynamic/`` package).

The static pipeline colors a graph once, from scratch.  Production graphs
mutate: edges arrive and leave continuously, and a from-scratch recoloring on
every batch throws away the near-fixed-point coloring already in hand.  This
package keeps a *device-resident* mutable encoding (ELL slots + COO overflow
spill) and repairs the coloring with the frontier-compacted fused RSOC pass,
seeded only from the endpoints of changed edges — work proportional to the
delta, not the graph.

  delta.py        fixed-shape batched edge insert/delete against ELL+overflow
  incremental.py  DynamicColoringState + recolor_incremental
  megabatch.py    slot-class stacking: one call of each wave body and one
                  slot-stride launch per repair chunk step N tenants
  service.py      ColoringService: long-lived multi-graph engine with a
                  double-buffered submit/step queue, megabatched stepping,
                  and a byte-budgeted version-memoized artifact cache
  sharded.py      ShardedColoringState + recolor_sharded: the mutable
                  encoding laid out per-shard over a device mesh, repaired
                  with one boundary-sized collective per round
"""
from repro_torch.dynamic.incremental import (  # noqa: F401
    DynamicColoringState, dynamic_state, recolor_incremental,
    state_from_numpy,
)
from repro_torch.dynamic.delta import state_to_csr  # noqa: F401
from repro_torch.dynamic.megabatch import slot_key, step_group  # noqa: F401
from repro_torch.dynamic.service import (  # noqa: F401
    ArtifactCache, ColoringService,
)
from repro_torch.dynamic.sharded import (  # noqa: F401
    ShardedColoringState, recolor_sharded, sharded_state,
)
