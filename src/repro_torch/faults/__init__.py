"""Deterministic fault injection + recovery (copy of
``src/repro/faults``).

``schedule``: seeded, hash-stamped fault schedules (crash, device loss,
straggler slowdown, power-backend failure, checkpoint corruption) that
train/serve/power hooks consult; ``supervisor``: bounded-restart
auto-resume wrapper around the training loop. Faults are data, not
monkeypatches — identical ``(preset, seed)`` reproduces the identical
failure story, so resilience is benchmarkable like any other workload.
"""
from repro_torch.faults.schedule import (  # noqa: F401
    DeviceLoss,
    FaultEvent,
    FaultSchedule,
    FlakyPower,
    InjectedCrash,
    InjectedFault,
    SERVE_PRESETS,
    TRAIN_PRESETS,
    corrupt_checkpoint,
)
from repro_torch.faults.supervisor import (  # noqa: F401
    SupervisorResult,
    run_supervised,
)
