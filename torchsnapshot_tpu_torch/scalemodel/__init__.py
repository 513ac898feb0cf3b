"""Scale models of the coordination plane.

Counterpart of ``torchsnapshot_tpu/scalemodel/``, cut to the CDN
subscriber storm (:mod:`.cdn_storm`): a publishing trainer and a fleet of
real :class:`~torchsnapshot_tpu_torch.cdn.CdnSubscriber` threads, with
read amplification, staleness and the dedup ratio. The thousand-rank
storm harness (``harness.py``) comes with the wire observatory (ROADMAP
step 10c).
"""

from .cdn_storm import (  # noqa: F401
    CdnStormConfig,
    CdnStormResult,
    build_step_chunks,
    run_cdn_storm,
)
