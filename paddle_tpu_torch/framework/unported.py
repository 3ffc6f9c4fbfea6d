"""Reference parameters the port accepts but does not implement.

A port signature keeps the reference's positional order, so a positional
call that is right for ``paddle_tpu`` binds the same parameters here. A
reference parameter without a port implementation is still accepted, and
any value other than its default raises (no silent fallback)."""
from __future__ import annotations


def require_defaults(owner: str, **params) -> None:
    """``params``: ``name=(value, default)``. Raise NotImplementedError
    naming ``owner`` for the first value that is not its default."""
    for name, (value, default) in params.items():
        differs = value is not None if default is None else value != default
        if differs:
            raise NotImplementedError(
                f"{owner}: {name}={value!r} is not ported (only "
                f"{name}={default!r})")


def unported(owner: str, what: str, item: str) -> None:
    """Raise NotImplementedError: ``owner`` does not port ``what`` yet,
    ROADMAP Queue A item ``item`` does."""
    raise NotImplementedError(f"{owner}: {what} is not ported yet "
                              f"(ROADMAP Queue A item {item})")
