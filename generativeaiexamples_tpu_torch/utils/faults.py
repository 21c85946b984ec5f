"""Fault-injection harness: named failure points the chaos tests drive (a
copy of the reference package's ``utils/faults.py``, same points).

Nothing in a serving stack can be called robust until its failure paths
have actually run. This module gives the request path a small set of
**named injection points** — places where a fault plan can make the code
raise, stall, or hang on demand:

======================  ====================================================
point                   where it fires
======================  ====================================================
``retrieval.search``    vector-store search (retrieval/docstore.py)
``embed``               query embedding (retrieval/docstore.py)
``engine.dispatch``     every engine device dispatch (admission prefill and
                        decode rounds, engine/engine.py scheduler thread)
``engine.harvest``      the engine's harvest worker, per harvested item
``http.connect``        outgoing HTTP connects (serving/client.py,
                        frontend/chat_client.py)
``router.forward``      every fleet-router forward attempt to a replica
                        (router/server.py, per attempt — retries re-fire)
``replica.heartbeat``   the router's per-replica heartbeat probe
                        (router/server.py)
``kv.offload``          the KV tier's eviction-time D2H page offload
                        (engine/engine.py serve loop; a failure drops
                        the pages exactly as the untiered engine did)
``kv.restore``          the KV tier's admission-time H2D page restore
                        (engine/engine.py; a failure falls back to
                        recomputing the tokens through prefill)
``kv.transfer``         the cross-replica prefix-page fetch
                        (engine/kv_tier.py fetch_blocks, on the
                        requesting side; a hang is bounded by the
                        transfer timeout and the request places cold)
``autoscale.execute``   the autoscale controller's executor call
                        (router/autoscale.py tick — a failure lands in
                        the decision record's ``executor.error`` and the
                        controller retries next cycle)
======================  ====================================================

A **fault plan** maps points to behaviors::

    retrieval.search=fail; engine.dispatch=delay:0.2; embed=fail*3

Points that act on a *set* of peers (the router's forwards and
heartbeats) accept an optional ``[tag]`` scope naming one peer::

    router.forward[r0]=fail:conn; replica.heartbeat[r0]=fail:conn

A tagged entry fires only when the call site passes a matching
``inject(point, tag=...)``; an untagged entry fires for every tag. This
is how a chaos test partitions ONE replica while its siblings stay
reachable — the failure mode rolling fleets actually see.

- ``fail``         raise ``FaultInjected`` at the point
- ``fail:Exc``     raise ``Exc`` (``timeout`` → ``TimeoutError``,
  ``conn`` → ``ConnectionError``) — for call sites whose retry/except
  logic matches on exception type
- ``delay:S``      sleep ``S`` seconds, then continue normally
- ``hang``         block until the plan is cleared (bounded by
  ``FAULT_HANG_MAX_S``, default 30 s, so a leaked plan can't wedge a
  test worker forever)
- ``*N`` suffix    fire only the first N times, then become a no-op

Plans come from the ``FAULT_PLAN`` env var at import time or from
``set_plan()`` at runtime (tests). With no plan active, ``inject()`` is a
module-flag check and a dict miss — effectively compiled out; none of the
serving hot paths pay for the harness in production.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Optional, Union

from .errors import FrameworkError

#: Every name ``inject()`` may be called with. A plan naming an unknown
#: point is a loud ConfigError-style failure — a typo'd chaos test that
#: silently injects nothing would "pass" while testing nothing.
POINTS = frozenset({
    "retrieval.search", "embed", "engine.dispatch", "engine.harvest",
    "http.connect", "router.forward", "replica.heartbeat",
    "kv.offload", "kv.restore", "kv.transfer", "autoscale.execute",
})

#: Upper bound on a ``hang`` fault, seconds (env-overridable).
HANG_MAX_S = float(os.environ.get("FAULT_HANG_MAX_S", "30"))


class FaultInjected(FrameworkError):
    """Raised by an active ``fail`` fault. Deliberately a FrameworkError:
    degradation paths that catch framework failures handle injected ones
    identically — that equivalence is the point of the harness."""


class FaultPlanError(FrameworkError):
    """A fault plan string could not be parsed or names an unknown point."""


_EXC_BY_NAME = {
    "faultinjected": FaultInjected,
    "timeout": TimeoutError,
    "conn": ConnectionError,
    "connectionerror": ConnectionError,
    "oserror": OSError,
}


@dataclass
class _Fault:
    mode: str                     # "fail" | "delay" | "hang"
    seconds: float = 0.0          # delay duration
    exc: type = FaultInjected     # what "fail" raises
    remaining: Optional[int] = None  # None = unlimited


# Plan state. ``_active`` is the fast-path gate: with no plan installed,
# inject() reads one module global and returns. The lock guards plan
# swaps and the countdown decrement only.
_lock = threading.Lock()
_plan: dict[str, _Fault] = {}
_active = False
_fired: dict[str, int] = {}


def _parse_one(point: str, spec: str) -> _Fault:
    times: Optional[int] = None
    if "*" in spec:
        spec, _, times_s = spec.partition("*")
        try:
            times = int(times_s)
        except ValueError:
            raise FaultPlanError(
                f"fault plan: bad repeat count {times_s!r} for {point}")
    mode, _, arg = spec.partition(":")
    mode = mode.strip().lower()
    if mode == "fail":
        exc = _EXC_BY_NAME.get(arg.strip().lower(), FaultInjected) if arg \
            else FaultInjected
        return _Fault("fail", exc=exc, remaining=times)
    if mode == "delay":
        try:
            seconds = float(arg)
        except ValueError:
            raise FaultPlanError(
                f"fault plan: delay needs numeric seconds, got {arg!r}")
        return _Fault("delay", seconds=seconds, remaining=times)
    if mode == "hang":
        return _Fault("hang", remaining=times)
    raise FaultPlanError(
        f"fault plan: unknown mode {mode!r} for {point} "
        f"(use fail|delay:<s>|hang)")


def parse_plan(text: str) -> dict[str, _Fault]:
    """``point[tag]=mode[:arg][*N]`` entries separated by ``;`` or ``,``
    (``[tag]`` optional — scopes the fault to one peer of a multi-peer
    point; see module docstring)."""
    plan: dict[str, _Fault] = {}
    for entry in text.replace(",", ";").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        point, sep, spec = entry.partition("=")
        point = point.strip()
        if not sep or not spec.strip():
            raise FaultPlanError(f"fault plan: malformed entry {entry!r}")
        base = point.split("[", 1)[0]
        if "[" in point and not point.endswith("]"):
            raise FaultPlanError(
                f"fault plan: malformed tag scope in {point!r} "
                f"(use point[tag]=...)")
        if base not in POINTS:
            raise FaultPlanError(
                f"fault plan: unknown injection point {base!r} "
                f"(known: {', '.join(sorted(POINTS))})")
        plan[point] = _parse_one(point, spec.strip())
    return plan


def set_plan(plan: Union[str, dict, None]) -> None:
    """Install a fault plan (string form, pre-parsed dict, or None/'' to
    clear). Replaces any previous plan atomically."""
    global _plan, _active
    new = (parse_plan(plan) if isinstance(plan, str) else dict(plan or {}))
    with _lock:
        _plan = new
        _fired.clear()
        _active = bool(new)


def clear() -> None:
    set_plan(None)


def active() -> bool:
    return _active


def fired(point: str) -> int:
    """How many times ``point`` has fired under the current plan."""
    return _fired.get(point, 0)


def inject(point: str, tag: Optional[str] = None) -> None:
    """Fire the configured fault at ``point``, if any. ``tag`` names the
    specific peer at multi-peer points (a replica, a heartbeat target):
    a ``point[tag]`` plan entry fires only on a matching tag; a bare
    ``point`` entry fires regardless. The production cost with no plan
    installed is this function's first two lines."""
    if not _active:
        return
    fault = None
    if tag is not None:
        fault = _plan.get(f"{point}[{tag}]")
        if fault is not None:
            point = f"{point}[{tag}]"  # per-scope fired() accounting
    if fault is None:
        fault = _plan.get(point)
    if fault is None:
        return
    with _lock:
        if fault.remaining is not None:
            if fault.remaining <= 0:
                return
            fault.remaining -= 1
        _fired[point] = _fired.get(point, 0) + 1
    if fault.mode == "delay":
        time.sleep(fault.seconds)
    elif fault.mode == "hang":
        deadline = time.monotonic() + HANG_MAX_S
        while time.monotonic() < deadline and _plan.get(point) is fault:
            time.sleep(0.02)
    else:
        raise fault.exc(f"injected fault at {point}")


# Env-configured plan: a chaos run exports FAULT_PLAN before starting the
# server; nothing else in the process needs to know.
_env_plan = os.environ.get("FAULT_PLAN", "").strip()
if _env_plan:
    set_plan(_env_plan)
