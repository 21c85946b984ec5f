"""CLI: serve the fleet router, or drain a replica for a rollout.

Serve::

    python -m generativeaiexamples_tpu_torch.router serve \\
        --replicas r0=http://chain-0:8081,r1=http://chain-1:8081 \\
        --port 8080 [--policy affinity]

Drain (what the k8s preStop hook runs — POST ``/control/drain`` on the
replica, then poll its ``/health`` until the in-flight stream count
reaches 0 or the wait budget expires)::

    python -m generativeaiexamples_tpu_torch.router drain \\
        --url http://127.0.0.1:8081 --wait 120

Undrain (rollback — re-open admission on a drained replica)::

    python -m generativeaiexamples_tpu_torch.router undrain \\
        --url http://127.0.0.1:8081
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional

from ..utils.logging import get_logger

logger = get_logger(__name__)


def parse_replicas(spec: str) -> list[tuple[str, str]]:
    """``name=url,name=url`` (or bare ``url,url`` → auto-named r0, r1…).

    Duplicate names are a hard error: ``ReplicaTable.add`` is
    last-writer-wins (the re-add/rollout story), so a collision —
    including a bare URL auto-named into an explicit name — would
    silently drop a replica from the fleet."""
    out: list[tuple[str, str]] = []
    seen: set[str] = set()
    for i, entry in enumerate(e.strip() for e in spec.split(",")):
        if not entry:
            continue
        if "=" in entry and not entry.startswith(("http://", "https://")):
            name, _, url = entry.partition("=")
            name, url = name.strip(), url.strip()
        else:
            name, url = f"r{i}", entry
        if name in seen:
            raise ValueError(f"duplicate replica name {name!r} in "
                             f"--replicas (auto-named bare URLs use "
                             f"their position: r0, r1, ...)")
        seen.add(name)
        out.append((name, url))
    return out


def drain(url: str, wait_s: float, poll_s: float = 1.0) -> int:
    """Flip the replica to draining (``serving.client.drain_replica`` —
    one implementation of the protocol), then wait for in-flight 0 by
    polling ``/health`` (a drained replica answers 503, and that body
    IS the signal the poll reads)."""
    from ..serving.client import drain_replica, get_json

    url = url.rstrip("/")
    try:
        body = drain_replica(url)
    except OSError as exc:
        print(f"drain: POST /control/drain failed: {exc}",
              file=sys.stderr)
        return 1
    in_flight = int(body.get("in_flight", 0))
    print(f"drain: admission closed, {in_flight} stream(s) in flight")
    deadline = time.monotonic() + wait_s
    while in_flight > 0 and time.monotonic() < deadline:
        time.sleep(poll_s)
        try:
            health = get_json(f"{url}/health", timeout=10.0)
            in_flight = int((health.get("load") or {}).get(
                "in_flight", in_flight))
        except OSError as exc:
            print(f"drain: health poll failed ({exc}); assuming drained")
            return 0
        except ValueError:
            pass  # non-JSON health answer; keep the last known count
    if in_flight > 0:
        print(f"drain: {in_flight} stream(s) still in flight after "
              f"{wait_s}s wait budget", file=sys.stderr)
        return 2
    print("drain: all in-flight streams finished")
    return 0


def undrain(url: str) -> int:
    """Re-open admission on a drained replica (rollback)."""
    from ..serving.client import undrain_replica

    try:
        body = undrain_replica(url.rstrip("/"))
    except OSError as exc:
        print(f"undrain: POST /control/undrain failed: {exc}",
              file=sys.stderr)
        return 1
    print(f"undrain: admission reopened "
          f"({body.get('in_flight', 0)} stream(s) in flight)")
    return 0


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="RAG fleet router")
    sub = parser.add_subparsers(dest="cmd")

    serve_p = sub.add_parser("serve", help="run the router")
    serve_p.add_argument("--replicas", default=os.environ.get(
        "ROUTER_REPLICAS", ""), help="name=url,... or url,...")
    serve_p.add_argument("--host", default="0.0.0.0")
    serve_p.add_argument("--port", type=int, default=8080)
    serve_p.add_argument("--policy", default=None,
                         choices=("affinity", "round_robin"))
    serve_p.add_argument("--autoscale", action="store_true",
                         help="attach the SLO-driven autoscale "
                              "controller (docs/autoscaling.md; knobs "
                              "via ROUTER_AUTOSCALE_* env) — same as "
                              "ROUTER_AUTOSCALE=1")
    serve_p.add_argument("--min-replicas", type=int, default=None,
                         help="autoscale floor (ROUTER_AUTOSCALE_MIN)")
    serve_p.add_argument("--max-replicas", type=int, default=None,
                         help="autoscale ceiling (ROUTER_AUTOSCALE_MAX; "
                              "default: the --replicas count)")

    drain_p = sub.add_parser("drain", help="drain one replica (preStop)")
    drain_p.add_argument("--url", required=True)
    drain_p.add_argument("--wait", type=float, default=120.0,
                         help="seconds to wait for in-flight streams")
    drain_p.add_argument("--poll", type=float, default=1.0)

    undrain_p = sub.add_parser(
        "undrain", help="re-open admission on a drained replica")
    undrain_p.add_argument("--url", required=True)

    args = parser.parse_args(argv)
    if args.cmd == "drain":
        return drain(args.url, args.wait, args.poll)
    if args.cmd == "undrain":
        return undrain(args.url)
    if args.cmd != "serve":
        parser.print_help()
        return 2

    from aiohttp import web

    from ..utils.logging import write_pid_file
    from .server import create_router_app

    try:
        replicas = parse_replicas(args.replicas)
    except ValueError as exc:
        print(f"serve: {exc}", file=sys.stderr)
        return 2
    # Pid file under the run dir ($GAIE_RUN_DIR) like both servers.
    # Logs go to stderr; redirect them under $GAIE_RUN_DIR too, never
    # the repo.
    write_pid_file(f"router-{args.port}")
    if not replicas:
        print("serve: --replicas (or ROUTER_REPLICAS) is required",
              file=sys.stderr)
        return 2
    autoscale = None
    if args.autoscale or os.environ.get("ROUTER_AUTOSCALE", "") \
            not in ("", "0", "false", "off"):
        from .autoscale import AutoscaleController, AutoscalePolicy

        def autoscale_factory(router):
            policy = AutoscalePolicy.from_env(
                min_replicas=args.min_replicas,
                max_replicas=(args.max_replicas
                              if args.max_replicas is not None
                              else (None if os.environ.get(
                                  "ROUTER_AUTOSCALE_MAX")
                                  else len(replicas))))
            return AutoscaleController(router, policy=policy,
                                       surge=router.surge)
        autoscale = autoscale_factory
    app = create_router_app(replicas, policy=args.policy,
                            autoscale_factory=autoscale)
    web.run_app(app, host=args.host, port=args.port)
    return 0


if __name__ == "__main__":
    sys.exit(main())
