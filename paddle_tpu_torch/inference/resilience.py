"""Terminal request outcomes (counterpart of the outcome half of
paddle_tpu/inference/resilience.py): a request that cannot be served
ends in a ``RequestOutcome`` in the engine's ``outcomes`` list instead
of an exception that kills the batch. The fault and crash injectors
come in a later slice."""
from __future__ import annotations

__all__ = ["RequestOutcome", "EngineCrash"]


class EngineCrash(RuntimeError):
    """Injected process death: the engine that raised it is to be
    abandoned and rebuilt from a snapshot. Deliberately not a BlockOOM
    subclass, so no engine-internal handler can swallow it."""


class RequestOutcome:
    """Terminal record of one serving request. Anything but FINISHED
    means the engine shed the request (its pages are freed, its slot
    reusable) while every other request kept stepping."""

    FINISHED = "finished"
    FAILED_OOM = "failed_oom"            # pool dry / retry budget blown
    FAILED_NUMERIC = "failed_numeric"    # non-finite hidden in the slot
    FAILED_DEADLINE = "failed_deadline"  # step / wall-clock budget blown
    REJECTED_ADMISSION = "rejected_admission"  # provably unservable
    FAILED_UNROUTABLE = "failed_unroutable"    # router: no live worker
    CANCELLED = "cancelled"              # deliberate early stop

    STATUSES = (FINISHED, FAILED_OOM, FAILED_NUMERIC, FAILED_DEADLINE,
                REJECTED_ADMISSION, FAILED_UNROUTABLE, CANCELLED)

    __slots__ = ("rid", "status", "reason", "tokens", "preemptions",
                 "step")

    def __init__(self, rid: int, status: str, reason: str = "",
                 tokens: int = 0, preemptions: int = 0, step: int = 0):
        if status not in self.STATUSES:
            raise ValueError(f"unknown outcome status {status!r}")
        self.rid = int(rid)
        self.status = status
        self.reason = reason
        self.tokens = int(tokens)        # consumed rows at termination
        self.preemptions = int(preemptions)
        self.step = int(step)            # engine step of the verdict

    @property
    def failed(self) -> bool:
        return self.status != self.FINISHED

    def as_dict(self) -> dict:
        return {"rid": self.rid, "status": self.status,
                "reason": self.reason, "tokens": self.tokens,
                "preemptions": self.preemptions, "step": self.step}

    def __repr__(self):
        tail = f", reason={self.reason!r}" if self.reason else ""
        return (f"RequestOutcome(rid={self.rid}, status={self.status}, "
                f"tokens={self.tokens}, step={self.step}{tail})")
