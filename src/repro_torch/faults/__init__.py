"""repro_torch.faults — deterministic fault injection + erasure recovery.

Port of ``repro.faults`` (numpy only).

The chaos layer for the split link: :class:`FaultPlan` is a seeded,
schedule-driven description of what the network does (drop / corrupt /
delay / duplicate / truncate / disconnect, per-direction rates or
explicit step lists, every draw replayable).  It installs into
``repro_torch.transport.Channel`` (payload-level erasures inside train
loops, resolved against a :class:`RecoveryPolicy` by
:func:`negotiate_payload`); :meth:`FaultPlan.frame_events` draws the
wire-level frame faults the front door injects
(``repro_torch.frontdoor.stream.FrameStream``).

:class:`ChannelErasure` is the typed "the channel ate it" error both
layers surface instead of decoding garbage.
"""
from repro_torch.faults.plan import (FAULT_KINDS, ChannelErasure,
                                     FaultEvent, FaultPlan)
from repro_torch.faults.recovery import (RecoveryPolicy, erasure_mask_like,
                                         negotiate_payload)

__all__ = [
    "FAULT_KINDS", "FaultEvent", "FaultPlan", "ChannelErasure",
    "RecoveryPolicy", "negotiate_payload", "erasure_mask_like",
]
