"""Named scopes for the program invariant analyzer: the port's
`jax.named_scope`.

A program wraps a reviewed site in `with scope("name"):`; the analyzer's
op recorder (`detectors.Recorder`) files every op dispatched inside under
the '/'-joined path of the open scopes, and a program's allowlists match
that path by substring.  Outside a recording a scope costs a list append
and pop.  The stack is per thread, as jax's name stack is.
"""
from __future__ import annotations

import contextlib
import threading

_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


@contextlib.contextmanager
def scope(name: str):
    """Open scope `name` around a block (nests)."""
    stack = _stack()
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()


def current() -> str:
    """The '/'-joined path of the open scopes ('' at the top)."""
    return "/".join(_stack())
