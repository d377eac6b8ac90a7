"""The one traffic generator: user requests over a call graph, sent by a
closed loop of sessions or an open loop of Poisson arrivals, every draw
from the run's seed.  A traffic mix is a JSON file of parameters beside
this module (``<name>.json``):

- ``kind``: ``closed`` (``sessions`` users, each sending its next request
  as soon as the last one finished; session starts spread over
  ``stagger_ticks`` ticks; ``warmup_ticks`` ticks before the window) or
  ``open`` (independent users arriving at ``rate_per_s``, ``warmup_s``
  seconds before the window; the gaps are the q quantiles of the
  exponential law, q the arrivals that the warm-up and the window hold
  at that rate, in an order drawn from the seed, so every seed offers a
  run the same gaps and the same number of arrivals);
- ``users``: ``{"user": name, "every": n}``: one session in n (drawn from
  the seed) carries ``user: name``; the others their own user id;
- ``graph``: the calls of one user request, each to a ``service`` with a
  ``path`` header and ``bytes`` of payload, sent when the calls it comes
  ``after`` have finished and, with ``when``, only if the named call was
  served by an instance of one of ``subsets``;
- ``check``: the sizes of the correctness check (``grid_every``: the
  stride of the ticks whose whole pool is compared; ``token_calls``: the
  calls whose tokens the reference model judges).

The generator hands each call to ``submit(rid, service, headers, token,
nbytes)`` and learns of finished and dropped calls from ``finished``; it
never reads the program's state.
"""

from __future__ import annotations

import array
import dataclasses

import numpy as np

from xlbench import seeded


@dataclasses.dataclass
class UserRequest:
    session: int
    start: float                 # host clock: first submission, or due time
    calls: dict                  # call name -> rid (sent calls)
    done: set                    # call names finished
    skipped: set                 # call names not sent (``when`` failed)
    end: float = 0.0
    failed: bool = False
    finished: bool = False
    lanes: dict = dataclasses.field(default_factory=dict)  # call -> lane


class Traffic:
    """Drives one traffic mix against ``submit``; ``lane_subset[lane]`` is
    the (service, subset) of each instance lane, for ``when``."""

    def __init__(self, spec: dict, seed: int, vocab: int, svc_id: dict,
                 lane_subset: list, submit, seconds: float = 0.0):
        self.spec = spec
        self.graph = {c["call"]: c for c in spec["graph"]}
        self.order = [c["call"] for c in spec["graph"]]
        self.svc_id = svc_id
        self.lane_subset = lane_subset
        self.submit_fn = submit
        self.vocab = vocab
        self.rng = seeded.rng(seed, seeded.TRAFFIC)
        self.next_rid = 0
        self.by_rid: dict[int, tuple] = {}      # rid -> (UserRequest, call)
        # what a run keeps of each call and user request, in flat arrays
        # the collector never scans: the tick each call was sent (by rid),
        # and each ended user request's start, end and failure
        self.sent_tick = array.array("q")
        self.starts, self.ends = array.array("d"), array.array("d")
        self.failed = array.array("b")
        self.closed = spec["kind"] == "closed"
        n = spec.get("sessions", 0)
        self.user_of = [f"u{k}" for k in range(n)]
        perm = self.rng.permutation(n) if n else []
        for u in spec.get("users", []):
            for k in range(n):
                if perm[k] % u["every"] == 0:
                    self.user_of[k] = u["user"]
        if self.closed:
            order = self.rng.permutation(n)
            stagger = max(spec.get("stagger_ticks", 0), 1)
            self.start_tick = {int(k): int(i * stagger // n)
                               for i, k in enumerate(order)}
            self.pending: list = []             # sessions to start next tick
        else:
            rate = spec["rate_per_s"]
            q = max(1, round(rate * (spec["warmup_s"] + seconds)))
            self.gaps = -np.log1p(-(np.arange(q) + 0.5) / q) / rate
            self.gap_i, self.due, self.origin = q, 0.0, None
            self.lateness = []                   # (due, seconds late)

    # ------------------------------------------------------------------ #
    def _token(self) -> int:
        return int(self.rng.integers(3, self.vocab))

    def _send(self, ur: UserRequest, name: str, tick: int, user: str):
        c = self.graph[name]
        rid = self.next_rid
        self.next_rid += 1
        headers = {"path": c["path"], "user": user}
        ur.calls[name] = rid
        self.by_rid[rid] = (ur, name)
        self.sent_tick.append(tick)
        self.submit_fn(rid, self.svc_id[c["service"]], headers,
                       self._token(), int(c["bytes"]))

    def _start(self, session: int, tick: int, start: float,
               user: str) -> None:
        ur = UserRequest(session, start, {}, set(), set())
        for name in self.order:
            if not self.graph[name]["after"]:
                self._send(ur, name, tick, user)

    def _next_gap(self) -> float:
        q = len(self.gaps)
        if self.gap_i == q:
            self.rng.shuffle(self.gaps)
            self.gap_i = 0
        self.gap_i += 1
        return float(self.gaps[self.gap_i - 1])

    # ------------------------------------------------------------------ #
    def before_tick(self, tick: int, now: float) -> None:
        """Send what is due before ``tick`` at host time ``now``."""
        if self.closed:
            for k, t in list(self.start_tick.items()):
                if t <= tick:
                    del self.start_tick[k]
                    self.pending.append(k)
            for k in self.pending:
                self._start(k, tick, now, self.user_of[k])
            self.pending = []
            return
        if self.origin is None:
            self.origin = now
            self.due = self._next_gap()
        while self.origin + self.due <= now:
            due = self.origin + self.due
            self.lateness.append((due, now - due))
            self._start(-1, tick, due, f"u{self.next_rid}")
            self.due += self._next_gap()

    def finished(self, tick: int, rid: int, t_done: float, dropped: bool,
                 lane: int | None) -> None:
        """Call ``rid`` finished (``dropped``: gave up) at host time
        ``t_done``, served on ``lane`` where a ``when`` needs it."""
        ur, name = self.by_rid.pop(rid)
        if ur.finished:
            return
        if dropped:
            ur.failed = ur.finished = True
            ur.end = t_done
            self._ended(ur)
            return
        ur.done.add(name)
        ur.end = max(ur.end, t_done)
        ur.lanes[name] = lane
        user = self._user(ur)
        for nxt in self.order:
            c = self.graph[nxt]
            if nxt in ur.calls or nxt in ur.skipped or not c["after"]:
                continue
            if not all(a in ur.done or a in ur.skipped for a in c["after"]):
                continue
            w = c.get("when")
            if w is not None and (w["call"] in ur.skipped or
                                  self.lane_subset[ur.lanes[w["call"]]][1]
                                  not in w["subsets"]):
                ur.skipped.add(nxt)
                continue
            self._send(ur, nxt, tick + 1, user)
        if len(ur.done) + len(ur.skipped) == len(self.order):
            ur.finished = True
            self._ended(ur)

    def needs_lane(self, rid: int) -> bool:
        """Whether a ``when`` reads the lane that served call ``rid``."""
        _, name = self.by_rid[rid]
        return any(c.get("when", {}).get("call") == name
                   for c in self.graph.values())

    def _user(self, ur: UserRequest) -> str:
        return self.user_of[ur.session] if ur.session >= 0 \
            else f"u{min(ur.calls.values())}"

    def _ended(self, ur: UserRequest) -> None:
        """Record an ended user request (no object of it is kept), and
        start its session's next one."""
        self.starts.append(ur.start)
        self.ends.append(ur.end)
        self.failed.append(ur.failed)
        if self.closed:
            self.pending.append(ur.session)

    def ended_between(self, t0: float, t1: float) -> tuple[list, int]:
        """The latencies (s) of the user requests completed in [t0, t1]
        on the host clock, and the count of those that failed there."""
        end = np.frombuffer(self.ends, np.float64)
        start = np.frombuffer(self.starts, np.float64)
        bad = np.frombuffer(self.failed, np.int8).astype(bool)
        inside = (end >= t0) & (end <= t1)
        return list(end[inside & ~bad] - start[inside & ~bad]), \
            int((inside & bad).sum())
