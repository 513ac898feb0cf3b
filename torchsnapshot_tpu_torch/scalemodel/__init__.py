"""Scale models of the coordination plane.

Counterpart of ``torchsnapshot_tpu/scalemodel/``: hundreds to a thousand
simulated ranks (threads with mock device state) drive the real
coordination code (``dist_store`` barriers and collectives, ``pg_wrapper``,
the ``fanout`` owner-table exchange, the endpoint registry) through save,
restore and preemption storms (:mod:`.harness`), and a publishing trainer
with a fleet of real :class:`~torchsnapshot_tpu_torch.cdn.CdnSubscriber`
threads measures read amplification, staleness, the dedup ratio and the
wire split (:mod:`.cdn_storm`).
"""

from .cdn_storm import (  # noqa: F401
    CdnStormConfig,
    CdnStormResult,
    build_step_chunks,
    run_cdn_storm,
)
from .harness import (  # noqa: F401
    CountingStore,
    PerKeyStore,
    SimulatedPreemption,
    StormConfig,
    StormResult,
    run_storm,
)
