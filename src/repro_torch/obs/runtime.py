"""The one switch every instrument checks.

Torch counterpart of ``repro/obs/runtime.py``.  Observability is off by
default, and every hot-path instrument call degrades to a single attribute
check while it is: engines, the plan cache, the tuner and the scheduler
are instrumented unconditionally, so the disabled path *is* the production
path.  The switch is a slotted singleton rather than a module global, so
:mod:`repro_torch.obs.metrics` and :mod:`repro_torch.obs.trace` share one
mutable flag, and reading it (``SWITCH.on``) allocates nothing.

``$REPRO_OBS=1`` arms the switch at import time, as it arms the
reference's.
"""
from __future__ import annotations

import os


class _Switch:
    __slots__ = ("on",)

    def __init__(self, on: bool = False):
        self.on = on


SWITCH = _Switch(os.environ.get("REPRO_OBS", "") in ("1", "true", "yes"))


def enable() -> None:
    SWITCH.on = True


def disable() -> None:
    SWITCH.on = False


def enabled() -> bool:
    return SWITCH.on
