"""Fleet router: prefix-affinity placement over N engine replicas.

The subsystem that turns one fast engine into a fleet (docs/router.md):

- :mod:`.table` — replica table, byte-block affinity sketches, the
  placement score (affinity + load + health);
- :mod:`.server` — the asyncio HTTP front: forwarding, connect-only
  retry, heartbeats, drain observation, dynamic membership;
- :mod:`.autoscale` — the SLO-driven autoscale controller + surge
  admission (docs/autoscaling.md) that closes the control loop over
  the :mod:`.fleet` snapshot;
- :mod:`.metrics` — the ``router_*`` metric surface (doc-enforced);
- ``python -m generativeaiexamples_tpu_torch.router`` — serve the router, or
  ``drain`` a replica for a rollout (the k8s preStop hook).
"""

from .autoscale import (AutoscaleController, AutoscalePolicy,  # noqa: F401
                        SurgeGate)
from .metrics import ROUTER_METRICS  # noqa: F401
from .server import FleetRouter, create_router_app  # noqa: F401
from .table import ReplicaTable, affinity_blocks  # noqa: F401
