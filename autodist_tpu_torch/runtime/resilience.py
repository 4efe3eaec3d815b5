"""Resilient control-plane RPC: deadlines, reconnect, idempotent retry.

PyTorch counterpart of ``autodist_tpu/runtime/resilience.py`` (that
module imports nothing of JAX; the port keeps its own copy). A breaker
that opens records the event in the flight recorder and dumps it
(``telemetry/blackbox.py``).

The raw :class:`~autodist_tpu_torch.runtime.coordination.CoordinationClient` is a
thin blocking socket — any dropped TCP connection, hung RPC, or service
blip surfaces as an ``OSError`` (or hangs forever without a deadline) at
whatever call happened to be in flight. The reference AutoDist never saw
this class of failure because the TF gRPC runtime absorbed it; our
hand-rolled wire needs an explicit policy, which lives here:

- **per-RPC deadlines** — every unary RPC carries ``ADT_RPC_TIMEOUT_S``
  (socket timeout); a hung service turns into a retryable timeout instead
  of an eternal stall. Blocking RPCs (BARRIER, WAITMIN) are exempt: they
  park server-side by design, and their liveness signal is the connection
  itself (a dead service drops it, which the retry loop handles).
- **automatic reconnect with jittered exponential backoff** — transport
  errors drop the connection and retry on a fresh one, up to a per-call
  retry budget (``ADT_RPC_RETRIES``). Jitter is seeded (deterministic
  under test) and prevents a thundering reconnect herd after a service
  restart.
- **a circuit breaker** — ``ADT_BREAKER_FAILURES`` consecutive transport
  failures open the circuit for ``ADT_BREAKER_COOLDOWN_S``; while open,
  calls fail fast with :class:`CircuitOpenError` instead of stacking
  connect timeouts (a worker behind a dead service degrades in bounded
  time to its caller's fallback — e.g. the PS pull's stale-serve window).
- **idempotency tokens** — retrying a side-effecting command (INC, STEP,
  BARRIER, BPUT, QPUSH) after an *ambiguous* drop (request possibly
  applied, reply lost) could double-apply it. Each logical call generates
  one client-unique token, reused verbatim across its retries; the
  service dedups on it and replays the recorded reply (see the
  'Idempotency tokens' section of coordination_service.cc). QPOP has no
  token: a retried pop could silently *re-deliver or lose* a gradient
  blob, so it is **at-most-once** — only connect-phase failures retry,
  an ambiguous in-flight failure raises to the caller (the async owner
  loop treats it as a transport blip and reconnects; a blob whose pop
  reply died on the wire is a dropped gradient, which pure-async
  semantics tolerate).

The wrapper exposes the same API surface as ``CoordinationClient`` so it
drops into ``CoordPSService`` factories and the Runner unchanged.
"""
import itertools
import random
import socket
import time
import uuid
from typing import Callable, List, Optional

from autodist_tpu_torch import const
from autodist_tpu_torch.runtime import elastic
from autodist_tpu_torch.telemetry import spans as tel
from autodist_tpu_torch.utils import logging


class CoordinationUnavailable(ConnectionError):
    """The coordination service stayed unreachable past the retry budget.

    Subclasses ``ConnectionError`` (an ``OSError``) so every existing
    transport-error handler — the watchdog, the async owner loop, the
    heartbeat reconnect — catches it without modification."""


class CircuitOpenError(CoordinationUnavailable):
    """Failing fast: the breaker is open after repeated transport errors."""


class ResilientCoordinationClient:
    """Deadline + retry + idempotency wrapper over ``CoordinationClient``.

    One instance owns (at most) one live connection and is **not** thread
    safe — same contract as the raw client; per-thread instances via a
    factory, exactly how ``CoordPSService`` already works.
    """

    def __init__(self, host: str = "127.0.0.1",
                 port: int = const.DEFAULT_COORDSVC_PORT,
                 rpc_timeout: Optional[float] = None,
                 max_retries: Optional[int] = None,
                 backoff_base_s: float = 0.05,
                 backoff_max_s: float = 2.0,
                 breaker_failures: Optional[int] = None,
                 breaker_cooldown_s: Optional[float] = None,
                 connect_timeout: Optional[float] = None,
                 seed: Optional[int] = None):
        self._host = host
        self._port = port
        if rpc_timeout is None:
            rpc_timeout = const.ENV.ADT_RPC_TIMEOUT_S.val
        self._rpc_timeout = rpc_timeout if rpc_timeout > 0 else None
        self._max_retries = (const.ENV.ADT_RPC_RETRIES.val
                             if max_retries is None else max_retries)
        self._backoff_base_s = backoff_base_s
        self._backoff_max_s = backoff_max_s
        self._breaker_failures = (const.ENV.ADT_BREAKER_FAILURES.val
                                  if breaker_failures is None
                                  else breaker_failures)
        self._breaker_cooldown_s = (const.ENV.ADT_BREAKER_COOLDOWN_S.val
                                    if breaker_cooldown_s is None
                                    else breaker_cooldown_s)
        self._connect_timeout = connect_timeout
        self._rng = random.Random(seed)
        self._client = None
        self._consecutive_failures = 0
        self._breaker_open_until = 0.0
        # token namespace: unique per client instance, monotonic sequence
        # per logical call — a retry reuses the SAME token
        self._token_prefix = uuid.uuid4().hex[:12]
        self._token_seq = itertools.count()
        self.stats = {"retries": 0, "reconnects": 0, "breaker_opens": 0,
                      "deduped_risk_calls": 0}

    # ------------------------------------------------------------ plumbing

    def _new_token(self) -> str:
        return "%s-%d" % (self._token_prefix, next(self._token_seq))

    def _connect(self):
        from autodist_tpu_torch.runtime.coordination import \
            CoordinationClient
        client = CoordinationClient(self._host, self._port,
                                    timeout=self._rpc_timeout,
                                    connect_timeout=self._connect_timeout)
        return client

    def _drop_client(self):
        if self._client is not None:
            try:
                self._client.close()
            except OSError:
                pass
            self._client = None

    def _note_failure(self):
        self._consecutive_failures += 1
        if self._consecutive_failures >= self._breaker_failures and \
                time.monotonic() >= self._breaker_open_until:
            self._breaker_open_until = (time.monotonic()
                                        + self._breaker_cooldown_s)
            self.stats["breaker_opens"] += 1
            tel.counter_add("coord.breaker_opens")
            tel.instant("coord.breaker_open", "coord",
                        target="%s:%d" % (self._host, self._port),
                        failures=self._consecutive_failures)
            logging.warning(
                "coordination circuit OPEN for %.1fs after %d consecutive "
                "transport failures to %s:%d",
                self._breaker_cooldown_s, self._consecutive_failures,
                self._host, self._port)
            # a breaker that opens is a black-box trigger: the dump keeps
            # the retry trail and the registry at the moment the control
            # plane was declared down
            from autodist_tpu_torch.telemetry import blackbox
            blackbox.record("coord.breaker_open",
                            target="%s:%d" % (self._host, self._port),
                            failures=self._consecutive_failures,
                            cooldown_s=self._breaker_cooldown_s)
            blackbox.dump("breaker_open")

    def _check_breaker(self):
        remaining = self._breaker_open_until - time.monotonic()
        if remaining > 0:
            raise CircuitOpenError(
                "coordination service circuit open for another %.1fs "
                "(%s:%d unreachable)" % (remaining, self._host, self._port))

    def _backoff(self, attempt: int):
        delay = min(self._backoff_max_s,
                    self._backoff_base_s * (2 ** attempt))
        # full jitter: [delay/2, delay] — seeded, so fault tests replay
        slept = delay * (0.5 + 0.5 * self._rng.random())
        with tel.span("coord.backoff", "coord", attempt=attempt):
            time.sleep(slept)
        tel.counter_add("coord.backoff_s", slept)

    def _call(self, fn: Callable, op: str, block: bool = False,
              retry_ambiguous: bool = True):
        """Run ``fn(raw_client)`` with reconnect + backoff + breaker.

        ``block=True`` lifts the per-RPC deadline for the call (BARRIER /
        WAITMIN park server-side legitimately). ``retry_ambiguous=False``
        (QPOP) retries only failures raised while CONNECTING — once a
        request may have hit the wire, the error propagates."""
        last_err: Optional[OSError] = None
        for attempt in range(self._max_retries + 1):
            self._check_breaker()
            if attempt:
                self.stats["retries"] += 1
                tel.counter_add("coord.retries")
                tel.instant("coord.retry", "coord", op=op, attempt=attempt)
                self._backoff(attempt - 1)
            try:
                if self._client is None:
                    self._client = self._connect()
                    self.stats["reconnects"] += 1
                    tel.counter_add("coord.reconnects")
            except OSError as e:
                last_err = e
                self._note_failure()
                continue
            client = self._client
            try:
                if block:
                    client.set_rpc_timeout(None)
                try:
                    result = fn(client)
                finally:
                    if block:
                        try:
                            client.set_rpc_timeout(self._rpc_timeout)
                        except OSError:
                            pass  # socket already dead: the except below
                            # (or the caller) owns the real error
            except (OSError, socket.timeout) as e:
                last_err = e
                self._note_failure()
                self._drop_client()
                if not retry_ambiguous:
                    raise
                continue
            self._consecutive_failures = 0
            return result
        raise CoordinationUnavailable(
            "coordination RPC %r to %s:%d failed after %d attempts "
            "(last error: %s)" % (op, self._host, self._port,
                                  self._max_retries + 1, last_err)
        ) from last_err

    # ------------------------------------------------- the client API

    def ping(self) -> bool:
        return self._call(lambda c: c.ping(), "ping")

    def put(self, key: str, value: str):
        # pure overwrite: naturally idempotent, no token needed.
        # Epoch-fenced: KV marks (heartbeat grace, straggler, mirror
        # digests) from a zombie incarnation must not poison the plane.
        elastic.maybe_fence("coord.put")
        return self._call(lambda c: c.put(key, value), "put")

    def get(self, key: str) -> Optional[str]:
        return self._call(lambda c: c.get(key), "get")

    def incr(self, name: str) -> int:
        elastic.maybe_fence("coord.incr")
        token = self._new_token()
        self.stats["deduped_risk_calls"] += 1
        return self._call(lambda c: c.incr(name, token=token), "incr")

    def barrier(self, name: str, num_workers: int):
        # a zombie arriving at a barrier would satisfy an arrival count
        # meant for its replacement — fenced like every mutation
        elastic.maybe_fence("coord.barrier")
        token = self._new_token()
        self.stats["deduped_risk_calls"] += 1
        return self._call(
            lambda c: c.barrier(name, num_workers, token=token),
            "barrier", block=True)

    def report_step(self, worker: str, step: int):
        elastic.maybe_fence("coord.step")
        token = self._new_token()
        self.stats["deduped_risk_calls"] += 1
        return self._call(
            lambda c: c.report_step(worker, step, token=token), "step")

    def min_step(self) -> int:
        return self._call(lambda c: c.min_step(), "min_step")

    def wait_staleness(self, my_step: int, staleness: int):
        # read-blocking: re-running re-evaluates the window, always safe
        return self._call(lambda c: c.wait_staleness(my_step, staleness),
                          "wait_staleness", block=True)

    def goodbye(self, worker: str):
        return self._call(lambda c: c.goodbye(worker), "goodbye")

    def heartbeat(self, worker: str):
        # a zombie's heartbeat would keep its dead identity "alive" at
        # the watchdog across epochs
        elastic.maybe_fence("coord.heartbeat")
        return self._call(lambda c: c.heartbeat(worker), "heartbeat")

    def bput(self, key: str, version: int, payload: bytes):
        elastic.maybe_fence("coord.bput")
        token = self._new_token()
        self.stats["deduped_risk_calls"] += 1
        return self._call(
            lambda c: c.bput(key, version, payload, token=token), "bput")

    def bget(self, key: str):
        return self._call(lambda c: c.bget(key), "bget")

    def qpush(self, queue: str, payload: bytes):
        elastic.maybe_fence("coord.qpush")
        token = self._new_token()
        self.stats["deduped_risk_calls"] += 1
        return self._call(lambda c: c.qpush(queue, payload, token=token),
                          "qpush")

    def qpop(self, queue: str):
        # at-most-once: see the module docstring — no token, no ambiguous
        # retry (a replayed pop would re-deliver; a blind retry would
        # double-pop and lose a blob)
        return self._call(lambda c: c.qpop(queue), "qpop",
                          retry_ambiguous=False)

    def qlen(self, queue: str) -> int:
        return self._call(lambda c: c.qlen(queue), "qlen")

    def dead_workers(self, timeout_s: float) -> List[str]:
        return self._call(lambda c: c.dead_workers(timeout_s),
                          "dead_workers")

    def reconnect(self):
        """Drop the current socket; the next call reconnects. Breaker and
        retry state are kept — this refreshes the transport, it does not
        forgive the service's failure history."""
        self._drop_client()

    def shutdown(self):
        # deliberate one-shot: retrying a shutdown against a service that
        # already exited just burns the whole retry budget on connects
        if self._client is None:
            self._client = self._connect()
        return self._client.shutdown()

    def close(self):
        self._drop_client()
