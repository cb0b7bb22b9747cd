"""Multi-tenant QoS: priority classes, token-rate admission budgets, and the
queue-drain Retry-After estimator (copy of ``dynamo_tpu/utils/qos.py``).

The QoS plane pushes back at three points, all built from this module:

  - **priority classes** (``critical`` | ``standard`` | ``batch``): stamped
    from the ``x-priority`` header or per-tenant/adapter policy, riding
    ``PreprocessedRequest`` -> ``EngineRequest`` like tenant tags. The
    scheduler composes class *weights* with the prefill fairness cap, admits
    the highest class first, and preempts ``batch`` lanes before anything
    else.
  - **admission control**: per-tenant windowed token buckets
    (``AdmissionController``) answer a structured retriable **429 +
    Retry-After** at the HTTP frontend BEFORE any SSE bytes when a tenant's
    token-rate budget is exhausted, and an engine-backpressure check (queue
    depth x measured drain rate vs the wait budget) sheds ``batch``-class
    load first.
  - **Retry-After from measurement**: ``DrainRateEstimator`` watches request
    completions and prices "how long until the queue drains", clamped to
    [1, 30] s.

Everything here is pure stdlib + thread-safe (the engine loop and the HTTP
thread both touch it), exposed as the ``dynamo_qos_*`` Prometheus families.
The reference's events journal is not ported yet (ROADMAP Queue 1 item 7):
its ``qos.*`` emits are left out of this copy.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from dynamo_tpu_torch.utils.prometheus import render_family

#: ordered most- to least-important; rank = index (lower = more important)
PRIORITY_CLASSES = ("critical", "standard", "batch")
DEFAULT_PRIORITY = "standard"

#: fairness-cap composition: one prefill start consumes 1/weight cap units,
#: so at the default per-step cap of 2 a critical burst can start 4 prefill
#: chains per step while batch work gets at most one — priority shapes the
#: exact serialization pressure the fairness cap exists to bound, instead of
#: adding a second competing throttle
PRIORITY_WEIGHTS = {"critical": 2.0, "standard": 1.0, "batch": 0.5}

_RANK = {c: i for i, c in enumerate(PRIORITY_CLASSES)}


def parse_priority(value: Optional[str]) -> str:
    """Strict parse of a client-supplied class name (the ``x-priority``
    header): unknown values raise so the frontend can answer a structured
    400 instead of silently serving at the wrong class."""
    if not value:
        return DEFAULT_PRIORITY
    v = str(value).strip().lower()
    if v not in _RANK:
        raise ValueError(
            f"unknown priority class {value!r} (expected one of {PRIORITY_CLASSES})"
        )
    return v


def priority_rank(cls: Optional[str]) -> int:
    """Scheduling rank (0 = most important). Unknown/empty values rank as
    ``standard`` — wire peers predating the QoS plane keep today's order."""
    return _RANK.get(cls or DEFAULT_PRIORITY, _RANK[DEFAULT_PRIORITY])


def priority_weight(cls: Optional[str]) -> float:
    return PRIORITY_WEIGHTS.get(cls or DEFAULT_PRIORITY, 1.0)


# ---------------- Retry-After from measured drain ----------------

RETRY_AFTER_MIN_S = 1.0
RETRY_AFTER_MAX_S = 30.0
#: fallback when nothing has finished yet (cold engine): the old constant
RETRY_AFTER_DEFAULT_S = 10.0


def retry_after_from_queue(
    queue_depth: int,
    drain_rps: Optional[float],
    default_s: float = RETRY_AFTER_DEFAULT_S,
) -> int:
    """Seconds a client should back off before retrying: the time the
    current queue takes to drain at the measured completion rate, clamped to
    [1, 30] s (sub-second advice churns reconnects; >30 s advice outlives
    any burst this plane is sized for). With no measured rate yet, the
    clamped default."""
    if drain_rps and drain_rps > 0:
        est = queue_depth / drain_rps if queue_depth > 0 else RETRY_AFTER_MIN_S
    else:
        est = default_s
    return int(round(min(RETRY_AFTER_MAX_S, max(RETRY_AFTER_MIN_S, est))))


class DrainRateEstimator:
    """Windowed request-completion rate (requests/s) off finish events.

    Fed by the engine's outcome sink (every natural finish, errors included
    — an erroring engine still drains its queue); read by the frontend's
    backpressure check and both retriable-status paths (429 and 503) so one
    measurement prices every Retry-After. Thread-safe."""

    def __init__(self, window_s: float = 60.0, max_samples: int = 2048,
                 clock=time.monotonic):
        self.window_s = window_s
        self._clock = clock
        self._lock = threading.Lock()
        from collections import deque

        self._finishes = deque(maxlen=max_samples)

    def note_finish(self, n: int = 1) -> None:
        now = self._clock()
        with self._lock:
            for _ in range(max(1, n)):
                self._finishes.append(now)

    def rate_rps(self) -> Optional[float]:
        """Completions per second over the window; None until anything
        finished (a cold engine must not fake an infinite drain rate)."""
        now = self._clock()
        cutoff = now - self.window_s
        with self._lock:
            while self._finishes and self._finishes[0] < cutoff:
                self._finishes.popleft()
            n = len(self._finishes)
            if n == 0:
                return None
            span = max(now - self._finishes[0], 1e-3)
        return n / span

    def retry_after_s(self, queue_depth: int) -> int:
        return retry_after_from_queue(queue_depth, self.rate_rps())


# ---------------- token buckets ----------------


class TokenBucket:
    """Windowed token-rate budget: ``rate`` tokens/s refill up to ``burst``
    capacity. NOT thread-safe on its own — the AdmissionController holds the
    lock (one lock for buckets + counters keeps admit() atomic)."""

    def __init__(self, rate: float, burst: Optional[float] = None,
                 clock=time.monotonic):
        if rate <= 0:
            raise ValueError(f"token bucket rate must be > 0; got {rate}")
        self.rate = float(rate)
        # default burst: 2 s of rate — enough that a single normal request
        # never throttles an idle tenant, small enough that a burst can't
        # pre-bank minutes of budget
        self.burst = float(burst) if burst is not None else 2.0 * self.rate
        self._clock = clock
        self._tokens = self.burst
        self._last = clock()

    def _refill(self, now: float) -> None:
        self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
        self._last = now

    def try_consume(self, n: float) -> bool:
        """Take ``n`` tokens if available. A request larger than the whole
        burst capacity is admitted when the bucket is FULL (draining it to
        zero) — a budget must throttle sustained overuse, not permanently
        deadlock one oversized-but-legitimate request."""
        now = self._clock()
        self._refill(now)
        need = min(float(n), self.burst)
        if self._tokens >= need - 1e-9:
            self._tokens -= need
            return True
        return False

    def fill_fraction(self) -> float:
        self._refill(self._clock())
        return self._tokens / self.burst if self.burst > 0 else 0.0

    def seconds_until(self, n: float) -> float:
        """Time until ``n`` tokens are available (0 if already)."""
        self._refill(self._clock())
        need = min(float(n), self.burst)
        deficit = need - self._tokens
        return max(0.0, deficit / self.rate)


# ---------------- policy ----------------


@dataclass
class QosPolicy:
    """Frontend QoS configuration: per-tenant token budgets + per-tenant/
    adapter default priority classes.

    Spec grammar (env ``DYNTPU_QOS_BUDGETS`` / ``DYNTPU_QOS_PRIORITIES`` or
    CLI/yaml passthrough):

        budgets:    "tenant-a=500,tenant-b=4000:8000,*=2000"
                    (``tenant=rate[:burst]`` tokens/s; ``*`` = default for
                    unlisted tenants; no ``*`` = unlisted tenants unlimited)
        priorities: "tenant-a=batch,tenant-b=critical,adapter:a1=batch"
                    (keys are tenant names or ``adapter:<name>``; the
                    x-priority header wins over policy)
    """

    # tenant -> (rate_tokens_per_s, burst_tokens or None)
    budgets: dict = field(default_factory=dict)
    default_budget: Optional[tuple] = None  # the "*" entry
    priorities: dict = field(default_factory=dict)  # tenant -> class
    adapter_priorities: dict = field(default_factory=dict)  # adapter -> class
    # backpressure shed: estimated queue wait beyond which batch-class load
    # sheds when no TTFT SLO target is configured to derive it from
    shed_wait_s: float = 10.0
    # fleet-shared admission: the number of frontend replicas the budget spec
    # is split across. Specs name the FLEET budget; each replica enforces
    # rate/N and burst/N deterministically, so N frontends together admit
    # exactly one shared budget's worth — no coordination traffic, no 2x
    # leakage from per-replica buckets (Mooncake's fleet-level admission
    # plane, done by arithmetic instead of consensus)
    fleet_replicas: int = 1

    @classmethod
    def from_specs(cls, budget_spec: str = "", priority_spec: str = "",
                   shed_wait_s: float = 10.0,
                   fleet_replicas: int = 1) -> "QosPolicy":
        budgets: dict = {}
        default_budget = None
        for rule in filter(None, (r.strip() for r in (budget_spec or "").split(","))):
            tenant, _, rhs = rule.partition("=")
            tenant = tenant.strip()
            if not rhs:
                raise ValueError(f"budget rule {rule!r} needs tenant=rate[:burst]")
            rate_s, _, burst_s = rhs.partition(":")
            rate = float(rate_s)
            burst = float(burst_s) if burst_s else None
            if tenant == "*":
                default_budget = (rate, burst)
            else:
                budgets[tenant] = (rate, burst)
        priorities: dict = {}
        adapter_priorities: dict = {}
        for rule in filter(None, (r.strip() for r in (priority_spec or "").split(","))):
            key, _, val = rule.partition("=")
            key = key.strip()
            if not val:
                raise ValueError(f"priority rule {rule!r} needs key=class")
            pcls = parse_priority(val)
            if key.startswith("adapter:"):
                adapter_priorities[key[len("adapter:"):]] = pcls
            else:
                priorities[key] = pcls
        if fleet_replicas < 1:
            raise ValueError(f"fleet_replicas must be >= 1; got {fleet_replicas}")
        return cls(budgets=budgets, default_budget=default_budget,
                   priorities=priorities, adapter_priorities=adapter_priorities,
                   shed_wait_s=shed_wait_s, fleet_replicas=fleet_replicas)

    @classmethod
    def from_env(cls, environ=None) -> Optional["QosPolicy"]:
        """Policy from DYNTPU_QOS_BUDGETS / DYNTPU_QOS_PRIORITIES (None when
        neither is set — the frontend runs without an admission plane)."""
        import os

        env = environ if environ is not None else os.environ
        budgets = env.get("DYNTPU_QOS_BUDGETS", "").strip()
        prios = env.get("DYNTPU_QOS_PRIORITIES", "").strip()
        if not budgets and not prios:
            return None
        shed = env.get("DYNTPU_QOS_SHED_WAIT_S", "").strip()
        replicas = env.get("DYNTPU_QOS_FLEET_REPLICAS", "").strip()
        return cls.from_specs(budgets, prios,
                              shed_wait_s=float(shed) if shed else 10.0,
                              fleet_replicas=int(replicas) if replicas else 1)

    def priority_for(self, tenant: str = "", adapter: str = "") -> str:
        """Policy default class for a request (header wins at the caller)."""
        if adapter and adapter in self.adapter_priorities:
            return self.adapter_priorities[adapter]
        return self.priorities.get(tenant, DEFAULT_PRIORITY)


# ---------------- admission controller ----------------


@dataclass
class AdmissionDecision:
    admitted: bool
    action: str  # admitted | throttled | shed
    retry_after_s: int = 0
    reason: str = ""


class AdmissionController:
    """The frontend admission plane: per-tenant token buckets + counters +
    the ``dynamo_qos_*`` exposition. One lock covers buckets and counters so
    an admit() is atomic under the asyncio + replay threads."""

    def __init__(self, policy: Optional[QosPolicy] = None, clock=time.monotonic):
        self.policy = policy or QosPolicy()
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: dict[str, TokenBucket] = {}
        # (class, tenant, action) -> count; action in admitted|throttled|shed
        self._counts: dict[tuple, int] = {}
        # tenant -> tokens actually admitted: the fleet-leakage audit trail
        # (summing this across replicas must stay inside ONE shared budget)
        self._admitted_tokens: dict[str, float] = {}

    def _bucket_for(self, tenant: str) -> Optional[TokenBucket]:
        b = self._buckets.get(tenant)
        if b is not None:
            return b
        spec = self.policy.budgets.get(tenant, self.policy.default_budget)
        if spec is None:
            return None  # unbudgeted tenant: never throttled here
        rate, burst = spec
        # fleet split: each of N replicas enforces 1/N of the fleet budget.
        # burst=None keeps the 2s-of-rate default, which divides with the
        # rate automatically
        n = max(1, int(self.policy.fleet_replicas))
        b = TokenBucket(rate / n, burst / n if burst is not None else None,
                        clock=self._clock)
        self._buckets[tenant] = b
        return b

    def _count(self, cls: str, tenant: str, action: str) -> None:
        key = (cls, tenant, action)
        self._counts[key] = self._counts.get(key, 0) + 1

    def admit(
        self, tenant: str, cls: str, tokens: int, request_id: str = ""
    ) -> AdmissionDecision:
        """Charge ``tokens`` (prompt + output budget) against the tenant's
        bucket. A throttle is a *retriable* verdict: Retry-After says when
        the bucket will hold this request's cost."""
        with self._lock:
            bucket = self._bucket_for(tenant)
            if bucket is None or bucket.try_consume(tokens):
                self._count(cls, tenant, "admitted")
                self._admitted_tokens[tenant] = (
                    self._admitted_tokens.get(tenant, 0.0) + float(tokens)
                )
                decision = AdmissionDecision(True, "admitted")
            else:
                wait = bucket.seconds_until(tokens)
                self._count(cls, tenant, "throttled")
                decision = AdmissionDecision(
                    False, "throttled",
                    retry_after_s=int(round(
                        min(RETRY_AFTER_MAX_S, max(RETRY_AFTER_MIN_S, wait))
                    )),
                    reason=f"tenant {tenant or 'default'!r} token budget exhausted",
                )
        # the reference journals qos.admitted / qos.throttled here: the events
        # journal arrives with ROADMAP Queue 1 item 7
        return decision

    def record_shed(self, tenant: str, cls: str, request_id: str = "") -> None:
        """One request shed by the engine-backpressure check (counted here so
        sheds and throttles read off one family)."""
        with self._lock:
            self._count(cls, tenant, "shed")
        # the reference journals qos.shed here (ROADMAP Queue 1 item 7)

    def snapshot(self) -> dict:
        with self._lock:
            counts = dict(self._counts)
            fills = {t: round(b.fill_fraction(), 4)
                     for t, b in self._buckets.items()}
            admitted = dict(self._admitted_tokens)
        out: dict = {"budget_fill": fills, "classes": {},
                     "admitted_tokens": admitted,
                     "fleet_replicas": max(1, int(self.policy.fleet_replicas))}
        for (cls, tenant, action), n in sorted(counts.items()):
            out["classes"].setdefault(cls, {}).setdefault(tenant, {})[action] = n
        return out

    def render_metrics(self) -> str:
        with self._lock:
            counts = sorted(self._counts.items())
            fills = sorted(
                (t, b.fill_fraction()) for t, b in self._buckets.items()
            )
        out = render_family(
            "dynamo_qos_requests_total", "counter",
            "admission-plane verdicts by priority class, tenant, and action "
            "(admitted; throttled = tenant token budget exhausted, 429; "
            "shed = engine backpressure shed batch-class load, 429)",
            [({"class": cls, "tenant": tenant, "action": action}, n)
             for (cls, tenant, action), n in counts]
            or [({"class": DEFAULT_PRIORITY, "tenant": "", "action": "admitted"}, 0)],
        )
        out += render_family(
            "dynamo_qos_budget_fill", "gauge",
            "per-tenant token-budget fill fraction (1 = full burst headroom, "
            "0 = exhausted; only budgeted tenants appear)",
            [({"tenant": t}, round(f, 4)) for t, f in fills]
            or [({"tenant": ""}, 1.0)],
        )
        return out
