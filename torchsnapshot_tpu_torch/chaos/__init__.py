"""Chaos engineering for the checkpoint stack.

Counterpart of ``torchsnapshot_tpu/chaos/``, under the same names.
Three pieces, one adversary description:

- **Fault plans** (:mod:`~torchsnapshot_tpu_torch.chaos.plan`): a seed plus a
  declarative fault list, serialized to ONE JSON line — every red run
  is replayable from a copy-paste.
- **The engine** (:mod:`~torchsnapshot_tpu_torch.chaos.engine`): evaluates a
  plan against injection events from any wrapped
  :class:`~torchsnapshot_tpu_torch.io_types.StoragePlugin`, coordination
  ``Store``, or the socket framing of the TCP store.
- **Crash points** (:mod:`~torchsnapshot_tpu_torch.chaos.crashpoints`): named
  kill points (``CRASH_*`` in telemetry/names.py) threaded through the
  take/commit/GC/mirror paths; the **crash-matrix harness**
  (:mod:`~torchsnapshot_tpu_torch.chaos.harness`) kills a take at every
  declared point and asserts the store's global invariants — fsck
  clean, newest committed step bit-identical, refcounts reconciled,
  journals healed, mirror resumed.
"""

from .crashpoints import (  # noqa: F401
    SimulatedCrash,
    arm,
    arm_engine,
    crashpoint,
    declared_crashpoints,
    disarm,
    hits,
)
from .engine import (  # noqa: F401
    ChaosEngine,
    ChaosStore,
    ChaosStoragePlugin,
    chaotic_plugin_type,
    corrupt_bytes,
    install_wire_chaos,
    uninstall_wire_chaos,
    wrap_plugin,
)
from .plan import (  # noqa: F401
    FaultPlan,
    FaultSpec,
    crash_plan,
    seeded_failure_plan,
)
