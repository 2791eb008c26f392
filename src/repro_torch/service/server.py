"""Mapping-as-a-service on the card: a threaded request front-end over
the fleet (the port of ``repro.service.server``).

``MappingServer`` turns the batch pipeline (``optimise_portfolio``) into
a streaming service: callers ``submit()`` individual mapping requests
from any thread and get back a ``concurrent.futures.Future`` resolving
to a :class:`MappingResponse`. A single dispatcher thread drains the
bounded admission queue and, per wave:

  1. fails requests whose deadline already passed (clean
     ``DeadlineExceeded``, never a poisoned round);
  2. answers repeats from the content-addressed
     :class:`~repro_torch.service.cache.SolvedCache`
     (``cache.request_key`` — equal keys imply identical lowered program
     + search config, so a cached design is bit-identical to a re-run);
  3. coalesces duplicate in-flight requests onto one engine run
     (``service.requests.coalesced``);
  4. groups torch rule-based requests by program shape
     (``fleet.bucket_key``) AND device, and advances each group in
     dynamic-membership lockstep rounds (``queue.run_rule_based_lockstep``,
     one ``_rb_descend_core`` call a round) — requests arriving mid-flight
     join the next round as fresh lanes, finished jobs idle as ``cap=0``
     no-op lanes; one group never mixes ``cpu`` and ``cuda`` lanes;
  5. runs everything else through the ordinary per-problem optimiser
     entry points on the resolved engine.

Every response is bit-identical to a direct
``OPTIMIZERS[optimiser](problem, engine=..., device=...)`` call for the
same request — tests/test_torch_service.py asserts this bitwise under
concurrency. Engines are the port's (``scalar``, ``numpy``, ``torch``;
``auto`` is ``torch``): a request naming ``engine="jax"`` fails on its
future as an unknown engine (HTTP 400), and a torch request with no card
and no ``device="cpu"`` fails fast with ``EngineUnavailable`` (HTTP 503)
— the service never falls back to the CPU.

The stdlib-HTTP adapter exposes ``POST /v1/mapping`` and ``POST
/v1/comap`` (multi-network co-mapping, ``pipeline.optimise_comapping``)
plus ``/healthz`` and ``/metricsz``; see ``python -m
repro_torch.service.server --help``.

Every statement but this docstring, ``_LOCKSTEP_KW``, ``_classify`` and
``_process`` is the JAX package's.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.accel import EngineUnavailable, resolve_engine
from repro_torch.core.exporter import ShardingPlan, export_plan
from repro_torch.core.optimizers import OPTIMIZERS
from repro_torch.core.optimizers.common import OptimResult
from repro_torch.core.pipeline import make_problem
from repro_torch.core.platform import Platform, V5E_POD
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.service.cache import SolvedCache, SolvedDesign, request_key
from repro_torch.service.queue import (
    AdmissionQueue,
    DeadlineExceeded,
    LockstepJob,
    ServiceClosed,
    ServiceError,
    ServiceOverloaded,
    run_rule_based_lockstep,
)

__all__ = ["MappingServer", "MappingResponse", "serve_http", "main",
           "ServiceError", "ServiceOverloaded", "ServiceClosed",
           "DeadlineExceeded"]

# rule_based kwargs the lockstep path covers; anything else routes
# through the per-problem loop (bit-identical either way)
_LOCKSTEP_KW = {"multi_start", "device"}


@dataclass(frozen=True)
class MappingResponse:
    """What a resolved request future holds."""

    plan: ShardingPlan
    result: OptimResult       # the full optimiser result (bit-identical
                              # to a direct engine call; tests rely on it)
    optimiser: str
    engine: str               # resolved engine name
    cached: bool              # answered from the solved-problem cache
    coalesced: bool           # rode another in-flight identical request
    total_s: float            # submit -> resolution wall time


class _Request:
    __slots__ = ("problem", "optimiser", "engine", "kwargs", "deadline",
                 "future", "submitted", "key", "resolved_engine")

    def __init__(self, problem, optimiser, engine, kwargs, deadline_s):
        self.problem = problem
        self.optimiser = optimiser
        self.engine = engine
        self.kwargs = kwargs
        self.submitted = time.monotonic()
        self.deadline = (self.submitted + deadline_s
                         if deadline_s is not None else None)
        self.future: Future = Future()
        self.key = None
        self.resolved_engine = None


class _Group:
    """All in-flight requests sharing one request_key; index 0 leads.

    ``result``/``error`` record the outcome so a request drained AFTER
    the group finished (a mid-wave poll can see that) still resolves
    instead of coalescing onto a dead group. ``route`` tags which run
    path owns the group so a failed lockstep can fail exactly its own
    groups, late joiners included."""

    __slots__ = ("key", "members", "result", "error", "route")

    def __init__(self, key, leader):
        self.key = key
        self.members = [leader]
        self.result: Optional[OptimResult] = None
        self.error: Optional[BaseException] = None
        self.route = None


class MappingServer:
    """Streaming mapping front-end (see module docstring).

    Usage::

        with MappingServer() as srv:
            fut = srv.submit("tinyllama-1.1b", shape, platform,
                             optimiser="rule_based", engine="auto")
            plan = fut.result().plan

    ``submit`` also works on a not-yet-started server: requests queue up
    and run when ``start()`` is called — tests use this to stage a
    deterministic batch. ``close(drain=True)`` (the context-manager
    exit) finishes queued work first; ``close(drain=False)`` fails
    pending requests with ``ServiceClosed``.
    """

    def __init__(self, cache: Optional[SolvedCache] = None,
                 cache_capacity: int = 512,
                 cache_path: Optional[str] = None,
                 max_pending: int = 256,
                 default_deadline_s: Optional[float] = None) -> None:
        self.cache = cache if cache is not None else SolvedCache(
            capacity=cache_capacity, path=cache_path)
        self.default_deadline_s = default_deadline_s
        self._queue = AdmissionQueue(maxsize=max_pending)
        self._closing = threading.Event()
        self._drain_on_close = True
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "MappingServer":
        if self._closing.is_set():
            raise ServiceClosed("server already closed")
        if self._thread is None:
            self._thread = threading.Thread(target=self._run,
                                            name="mapping-dispatcher",
                                            daemon=True)
            self._thread.start()
        return self

    def close(self, drain: bool = True, timeout: Optional[float] = None
              ) -> None:
        self._drain_on_close = drain
        self._closing.set()
        if self._thread is not None:
            self._thread.join(timeout)
        for req in self._queue.drain():
            self._fail(req, ServiceClosed(
                "server closed before this request ran"))

    def __enter__(self) -> "MappingServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close(drain=True)

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def submit_problem(self, problem, *, optimiser: str = "rule_based",
                       engine: str = "auto",
                       deadline_s: Optional[float] = None,
                       **optimiser_kwargs) -> Future:
        """Queue one already-built ``Problem``; returns a Future of
        :class:`MappingResponse`. Raises ``ServiceOverloaded`` when the
        pending queue is full and ``ServiceClosed`` after ``close()``."""
        if self._closing.is_set():
            raise ServiceClosed("server is closed")
        if optimiser not in OPTIMIZERS:
            raise ValueError(f"unknown optimiser {optimiser!r}; "
                             f"choose from {sorted(OPTIMIZERS)}")
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        req = _Request(problem, optimiser, engine, dict(optimiser_kwargs),
                       deadline_s)
        self._queue.push(req)
        _metrics.counter("service.requests.submitted").inc()
        return req.future

    def submit(self, arch, shape: ShapeSpec,
               platform: Platform = V5E_POD, *, backend: str = "spmd",
               optimiser: str = "rule_based",
               objective: str = "throughput",
               exec_model: str = "streaming", opts=None,
               engine: str = "auto",
               deadline_s: Optional[float] = None,
               **optimiser_kwargs) -> Future:
        """Build the ``Problem`` (``arch`` may be an ``ArchConfig`` or a
        registry name) and queue it — the streaming counterpart of
        ``pipeline.optimise_mapping``."""
        if isinstance(arch, str):
            arch = get_arch(arch)
        if not isinstance(arch, ArchConfig):
            raise TypeError(f"arch must be an ArchConfig or registry "
                            f"name, got {type(arch).__name__}")
        problem = make_problem(arch, shape, platform, backend, objective,
                               exec_model, opts)
        return self.submit_problem(problem, optimiser=optimiser,
                                   engine=engine, deadline_s=deadline_s,
                                   **optimiser_kwargs)

    @staticmethod
    def result(future: Future, timeout: Optional[float] = None
               ) -> MappingResponse:
        """Convenience: block on a submitted future."""
        return future.result(timeout)

    # ------------------------------------------------------------------
    # co-mapping (synchronous: one request is already a whole fleet)
    # ------------------------------------------------------------------
    def solve_comap(self, archs, shape: ShapeSpec,
                    platform: Platform = V5E_POD, *,
                    backend: str = "spmd",
                    optimiser: str = "rule_based",
                    objective: str = "weighted_throughput",
                    weights=None, exec_model: str = "streaming",
                    opts=None, engine: str = "auto", splits=None,
                    **optimiser_kwargs):
        """Jointly map N architectures onto one shared platform
        (``pipeline.optimise_comapping``; POST /v1/comap).

        Synchronous by design: a single co-mapping request already fans
        out S x N optimiser lanes (one fleet program on the jax
        engine), so there is nothing for the dispatcher to batch it
        with — it runs on the calling thread and returns the
        ``CoMapPlan`` directly. ``archs`` entries may be ``ArchConfig``s
        or registry names."""
        if self._closing.is_set():
            raise ServiceClosed("server is closed")
        from repro_torch.core.pipeline import optimise_comapping
        with _trace.span("service.comap", nets=len(archs),
                         optimiser=optimiser, engine=engine):
            t0 = time.monotonic()
            plan = optimise_comapping(
                archs, shape, platform, backend=backend,
                optimiser=optimiser, objective=objective,
                weights=weights, exec_model=exec_model, opts=opts,
                engine=engine, splits=splits, **optimiser_kwargs)
            _metrics.counter("service.comap.requests").inc()
            if not plan.feasible:
                _metrics.counter("service.comap.infeasible").inc()
            _metrics.histogram("service.comap.latency_s").observe(
                time.monotonic() - t0)
            return plan

    # ------------------------------------------------------------------
    # dispatcher
    # ------------------------------------------------------------------
    def _run(self) -> None:
        while True:
            self._queue.wait(0.05)
            if self._closing.is_set() and not self._drain_on_close:
                break
            batch = self._queue.drain()
            if batch:
                try:
                    self._process(batch)
                except Exception as e:      # pragma: no cover (defensive)
                    for req in batch:
                        self._fail(req, e)
            elif self._closing.is_set():
                break

    def _fail(self, req: _Request, exc: BaseException) -> None:
        if not req.future.done():
            req.future.set_exception(exc)
            _metrics.counter("service.requests.failed").inc()

    def _expired(self, req: _Request) -> bool:
        if req.deadline is not None and time.monotonic() > req.deadline:
            if not req.future.done():
                req.future.set_exception(DeadlineExceeded(
                    "deadline passed before the request ran"))
                _metrics.counter("service.requests.expired").inc()
            return True
        return req.future.done()

    def _resolve(self, req: _Request, result: OptimResult, *,
                 cached: bool, coalesced: bool) -> None:
        if self._expired(req):
            return
        p = req.problem
        plan = export_plan(p.graph, result.variables, p.platform,
                           p.exec_model, result.evaluation)
        total = time.monotonic() - req.submitted
        _metrics.histogram("service.latency_s").observe(total)
        _metrics.counter("service.requests.completed").inc()
        req.future.set_result(MappingResponse(
            plan=plan, result=result, optimiser=req.optimiser,
            engine=req.resolved_engine, cached=cached,
            coalesced=coalesced, total_s=total))

    def _finish_group(self, grp: _Group, result: OptimResult, *,
                      from_engine: bool) -> None:
        grp.result = result
        if from_engine:
            self.cache.put(grp.key, SolvedDesign.from_result(result))
            _metrics.counter("service.engine_runs").inc()
        for i, req in enumerate(grp.members):
            self._resolve(req, result, cached=not from_engine,
                          coalesced=i > 0)

    def _fail_group(self, grp: _Group, exc: BaseException) -> None:
        grp.error = exc
        for req in grp.members:
            self._fail(req, exc)

    def _classify(self, req: _Request, groups: "Dict[str, _Group]",
                  lockstep: Dict[tuple, List[LockstepJob]],
                  loop_groups: List[_Group]) -> None:
        """Route one drained request: fail, cache-hit, coalesce, or lead
        a new group on the lockstep / per-problem path."""
        if self._expired(req):
            return
        try:
            req.resolved_engine = resolve_engine(req.engine)
            device = None
            if req.resolved_engine == "torch":
                # no card and no device="cpu": EngineUnavailable here,
                # never a silent run on the CPU
                from repro_torch.runtime import resolve_device
                device = resolve_device(req.kwargs.get("device"))
            req.key = request_key(req.problem, req.optimiser,
                                  req.resolved_engine, req.kwargs)
        except Exception as e:
            self._fail(req, e)
            return
        grp = groups.get(req.key)
        if grp is not None:
            _metrics.counter("service.requests.coalesced").inc()
            if grp.result is not None:      # group finished mid-wave
                self._resolve(req, grp.result, cached=True,
                              coalesced=True)
            elif grp.error is not None:
                self._fail(req, grp.error)
            else:
                grp.members.append(req)
            return
        design = self.cache.get(req.key)
        if design is not None:
            req_grp = _Group(req.key, req)
            self._finish_group(req_grp, design.to_result(req.problem),
                               from_engine=False)
            return
        grp = _Group(req.key, req)
        groups[req.key] = grp
        if (req.resolved_engine == "torch"
                and req.optimiser == "rule_based"
                and set(req.kwargs) <= _LOCKSTEP_KW):
            from repro_torch.core.accel.fleet import bucket_key
            # one lockstep stack holds the lanes of one device
            sig = (bucket_key(req.problem), str(device))
            grp.route = ("lockstep", sig)
            lockstep.setdefault(sig, []).append(LockstepJob(
                req.problem,
                multi_start=req.kwargs.get("multi_start", True), tag=grp))
        else:
            grp.route = "loop"
            loop_groups.append(grp)

    def _poll(self, groups: "Dict[str, _Group]", sig,
              deferred: List[_Request]) -> List[LockstepJob]:
        """Late-joiner harvest at a lockstep round boundary: drain the
        queue; expired requests fail, repeats hit the cache or coalesce
        onto in-flight groups, signature-compatible newcomers become
        fresh lanes, everything else defers to the next wave."""
        jobs: List[LockstepJob] = []
        lockstep: Dict[tuple, List[LockstepJob]] = {}
        rest: List[_Group] = []
        for req in self._queue.drain():
            self._classify(req, groups, lockstep, rest)
        jobs.extend(lockstep.pop(sig, []))
        defer = [j.tag for js in lockstep.values() for j in js] + rest
        for grp in defer:        # wrong signature / loop path: next wave
            del groups[grp.key]
            deferred.extend(grp.members)
        if jobs:
            _metrics.counter("service.requests.late_joined").inc(
                len(jobs))
        return jobs

    def _process(self, batch: List[_Request]) -> None:
        work = list(batch)
        while work:
            groups: Dict[str, _Group] = {}
            lockstep: Dict[tuple, List[LockstepJob]] = {}
            loop_groups: List[_Group] = []
            for req in work:
                self._classify(req, groups, lockstep, loop_groups)
            work = []
            for sig, jobs in lockstep.items():
                with _trace.span("service.lockstep", jobs=len(jobs)):
                    try:
                        run_rule_based_lockstep(
                            jobs, device=sig[1],
                            poll=lambda: self._poll(groups, sig, work),
                            on_done=lambda job, result: (
                                _metrics.note_result(result,
                                                     engine="service"),
                                self._finish_group(job.tag, result,
                                                   from_engine=True)))
                    except Exception as e:
                        # fail every unresolved group this lockstep run
                        # owned, late joiners included
                        for grp in list(groups.values()):
                            if (grp.route == ("lockstep", sig)
                                    and grp.result is None
                                    and grp.error is None):
                                self._fail_group(grp, e)
            for grp in loop_groups:
                req = grp.members[0]
                with _trace.span("service.loop_run",
                                 optimiser=req.optimiser,
                                 engine=req.resolved_engine):
                    try:
                        result = OPTIMIZERS[req.optimiser](
                            req.problem, engine=req.resolved_engine,
                            **req.kwargs)
                    except Exception as e:
                        self._fail_group(grp, e)
                        continue
                self._finish_group(grp, result, from_engine=True)


# ----------------------------------------------------------------------
# stdlib HTTP adapter
# ----------------------------------------------------------------------

def _plan_summary(resp: MappingResponse) -> dict:
    plan = resp.plan
    return {
        "arch": plan.arch_name,
        "shape": plan.shape_name,
        "mode": plan.mode,
        "exec_model": plan.exec_model,
        "platform": plan.platform.name,
        "partitions": len(plan.partitions),
        "objective_value": plan.objective_value,
        "throughput": plan.throughput,
        "latency": plan.latency,
        "optimiser": resp.optimiser,
        "engine": resp.engine,
        "cached": resp.cached,
        "coalesced": resp.coalesced,
        "total_s": resp.total_s,
        "points": int(resp.result.points),
    }


def _parse_request(body: dict):
    """Decode one POST /v1/mapping JSON body into submit() arguments."""
    arch = get_arch(str(body["arch"]))
    if body.get("reduced"):
        from repro_torch.configs import reduced
        arch = reduced(arch)
    sh = body.get("shape") or {}
    shape = ShapeSpec(str(sh.get("name", "serve")),
                      int(sh.get("seq_len", 256)),
                      int(sh.get("global_batch", 16)),
                      str(sh.get("mode", "train")))
    pl = body.get("platform")
    if pl is None:
        platform = V5E_POD
    else:
        axes = tuple((str(n), int(s)) for n, s in pl["mesh_axes"])
        scalars = {k: float(pl[k]) for k in
                   ("peak_flops", "hbm_bw", "hbm_bytes", "ici_bw",
                    "dma_bw", "reconf_fixed_s", "vmem_bytes") if k in pl}
        platform = Platform(name=str(pl.get("name", "custom")),
                            mesh_axes=axes, **scalars)
    kwargs = dict(body.get("optimiser_kwargs") or {})
    return dict(arch=arch, shape=shape, platform=platform,
                backend=str(body.get("backend", "spmd")),
                optimiser=str(body.get("optimiser", "rule_based")),
                objective=str(body.get("objective", "throughput")),
                exec_model=str(body.get("exec_model", "streaming")),
                engine=str(body.get("engine", "auto")),
                deadline_s=(float(body["deadline_s"])
                            if body.get("deadline_s") is not None
                            else None),
                **kwargs)


def _parse_comap_request(body: dict):
    """Decode one POST /v1/comap JSON body into solve_comap() arguments."""
    names = body["archs"]
    if isinstance(names, str):
        raise ValueError("archs must be a list of registry names, got a "
                         "single string")
    archs = [get_arch(str(a)) for a in names]
    if body.get("reduced"):
        from repro_torch.configs import reduced
        archs = [reduced(a) for a in archs]
    sh = body.get("shape") or {}
    shape = ShapeSpec(str(sh.get("name", "serve")),
                      int(sh.get("seq_len", 256)),
                      int(sh.get("global_batch", 16)),
                      str(sh.get("mode", "train")))
    pl = body.get("platform")
    if pl is None:
        platform = V5E_POD
    else:
        axes = tuple((str(n), int(s)) for n, s in pl["mesh_axes"])
        scalars = {k: float(pl[k]) for k in
                   ("peak_flops", "hbm_bw", "hbm_bytes", "ici_bw",
                    "dma_bw", "reconf_fixed_s", "vmem_bytes") if k in pl}
        platform = Platform(name=str(pl.get("name", "custom")),
                            mesh_axes=axes, **scalars)
    weights = body.get("weights")
    splits = body.get("splits")
    kwargs = dict(body.get("optimiser_kwargs") or {})
    return dict(archs=archs, shape=shape, platform=platform,
                backend=str(body.get("backend", "spmd")),
                optimiser=str(body.get("optimiser", "rule_based")),
                objective=str(body.get("objective",
                                       "weighted_throughput")),
                weights=(None if weights is None
                         else [float(w) for w in weights]),
                exec_model=str(body.get("exec_model", "streaming")),
                engine=str(body.get("engine", "auto")),
                splits=(None if splits is None
                        else [[int(p) for p in s] for s in splits]),
                **kwargs)


def _comap_summary(plan) -> dict:
    return {
        "feasible": plan.feasible,
        "split_index": plan.split_index,
        "split": list(plan.split),
        "objective": plan.objective,
        "objective_value": plan.objective_value,
        "points": int(plan.result.points),
        "total_s": plan.result.seconds,
        "violations": list(plan.result.evaluation.violations)
        if not plan.feasible else [],
        "nets": [{
            "arch": p.arch_name,
            "platform": p.platform.name,
            "partitions": len(p.partitions),
            "objective_value": p.objective_value,
            "throughput": p.throughput,
            "latency": p.latency,
        } for p in plan.plans],
    }


def serve_http(server: MappingServer, host: str = "127.0.0.1",
               port: int = 8754, request_timeout_s: float = 300.0):
    """Wrap a started ``MappingServer`` in a ``ThreadingHTTPServer``.

    Returns the httpd; call ``serve_forever()`` on it (``main()`` does)
    or drive it from a test with one-shot ``handle_request()`` calls.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, fmt, *args):   # quiet by default
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True})
            elif self.path == "/metricsz":
                self._send(200, _metrics.snapshot())
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path == "/v1/mapping":
                self._do_mapping()
            elif self.path == "/v1/comap":
                self._do_comap()
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def _do_mapping(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                kw = _parse_request(body)
            except Exception as e:
                self._send(400, {"error": f"bad request: {e}"})
                return
            try:
                fut = server.submit(**kw)
                timeout = kw["deadline_s"] or request_timeout_s
                resp = fut.result(timeout)
            except (EngineUnavailable, ServiceOverloaded) as e:
                self._send(503, {"error": str(e)})
            except (DeadlineExceeded, TimeoutError) as e:
                self._send(504, {"error": str(e) or "deadline exceeded"})
            except (ValueError, TypeError, KeyError) as e:
                self._send(400, {"error": str(e)})
            except Exception as e:
                self._send(500, {"error": str(e)})
            else:
                self._send(200, _plan_summary(resp))

        def _do_comap(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                kw = _parse_comap_request(body)
            except Exception as e:
                self._send(400, {"error": f"bad request: {e}"})
                return
            try:
                plan = server.solve_comap(**kw)
            except (EngineUnavailable, ServiceOverloaded) as e:
                self._send(503, {"error": str(e)})
            except (ValueError, TypeError, KeyError) as e:
                self._send(400, {"error": str(e)})
            except Exception as e:
                self._send(500, {"error": str(e)})
            else:
                self._send(200, _comap_summary(plan))

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="mapping-as-a-service HTTP front-end")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8754)
    ap.add_argument("--cache-capacity", type=int, default=512)
    ap.add_argument("--cache-path", default=None,
                    help="JSONL persistence for the solved-design cache")
    ap.add_argument("--max-pending", type=int, default=256)
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="default per-request deadline")
    args = ap.parse_args(argv)
    server = MappingServer(cache_capacity=args.cache_capacity,
                           cache_path=args.cache_path,
                           max_pending=args.max_pending,
                           default_deadline_s=args.deadline_s).start()
    httpd = serve_http(server, args.host, args.port)
    print(f"[service] listening on http://{args.host}:{args.port} "
          f"(POST /v1/mapping)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.close(drain=True)
        if server.cache.path:
            server.cache.save()
    return 0


if __name__ == "__main__":
    sys.exit(main())
