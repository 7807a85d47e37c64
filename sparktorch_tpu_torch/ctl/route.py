"""The gang control route: verbs a controller can POST at a process — a copy of ``sparktorch_tpu/ctl/route.py``.

A :class:`CtlRegistry` of named verbs that
:class:`~sparktorch_tpu_torch.native.gang.GangMetricsExporter` mounts
as ``POST /ctl``, so the elastic controller can ``kill`` or ``drain`` a
rank it holds no process handle on; :func:`ctl_request` posts one verb.

The token (``SPARKTORCH_TPU_CTL_TOKEN`` or an explicit ``token=``)
travels as ``X-Ctl-Token``; it keeps a stray client or a recycled-port
neighbour from killing ranks by accident. With no token configured the
route is open, and :meth:`CtlRegistry.check_token` says so.

The registry is duck-typed (``check_token`` + ``handle``): the exporter
mounts it without importing this package, so ``ctl/`` imports
``native/`` and ``obs/``, never the reverse.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Mapping, Optional

from sparktorch_tpu_torch.obs.collector import post_json
from sparktorch_tpu_torch.obs.log import get_logger

CTL_TOKEN_ENV = "SPARKTORCH_TPU_CTL_TOKEN"

_LOG = get_logger("sparktorch_tpu_torch.ctl.route")


class CtlRefused(RuntimeError):
    """The control endpoint refused the verb (bad token, unknown verb,
    unknown rank) or was unreachable."""


class CtlRegistry:
    """Named verb handlers behind one token check.

    ``register(verb, fn)`` mounts ``fn(**args)``; ``handle`` dispatches
    one request (KeyError on unknown verbs — the HTTP layers translate
    that to 400). Thread-safe: HTTP handler threads dispatch while the
    owning process registers/unregisters verbs.
    """

    def __init__(self, token: Optional[str] = None):
        self.token = token if token is not None \
            else os.environ.get(CTL_TOKEN_ENV)
        self._verbs: Dict[str, Callable[..., Any]] = {}
        self._lock = threading.Lock()

    def register(self, verb: str, fn: Callable[..., Any]) -> None:
        with self._lock:
            self._verbs[str(verb)] = fn

    def verbs(self) -> list:
        with self._lock:
            return sorted(self._verbs)

    def check_token(self, token: Optional[str]) -> bool:
        if not self.token:
            return True  # unguarded: no secret configured
        return token == self.token

    def handle(self, verb: Any, args: Mapping[str, Any]) -> Any:
        with self._lock:
            fn = self._verbs[str(verb)]  # KeyError -> HTTP 400
        return fn(**dict(args))


def ctl_request(url: str, verb: str, token: Optional[str] = None,
                timeout: float = 5.0, **args: Any) -> Dict[str, Any]:
    """POST one verb at a ``/ctl`` endpoint (an exporter's, or the
    collector's fan-out). Returns the decoded reply document; raises
    :class:`CtlRefused` on refusal or unreachability — callers decide
    whether a refused kill is fatal (it usually is not: the rank the
    controller wanted dead may already be dead)."""
    from sparktorch_tpu_torch.obs.collector import ScrapeError

    token = token if token is not None else os.environ.get(CTL_TOKEN_ENV)
    headers = {"X-Ctl-Token": token} if token else None
    try:
        reply = post_json(url.rstrip("/") + "/ctl",
                          {"verb": verb, "args": args},
                          timeout=timeout, headers=headers)
    except ScrapeError as e:
        raise CtlRefused(f"{verb} @ {url}: {e}") from e
    if not isinstance(reply, dict) or not reply.get("ok", False):
        raise CtlRefused(f"{verb} @ {url}: refused: {reply!r}")
    return reply
