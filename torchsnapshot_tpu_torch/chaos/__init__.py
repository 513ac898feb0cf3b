"""Chaos engineering for the checkpoint stack: the named crash points.

Counterpart of ``torchsnapshot_tpu/chaos/``, cut to the ``crashpoint``
hook that the manager calls. The fault plans, the engine that arms the
points and the crash-matrix harness are not ported yet (ROADMAP queue 1
step 9b); until then every crash point is a no-op and arming one raises.
"""

from .crashpoints import arm, arm_engine, crashpoint  # noqa: F401
