"""The plain reference of the serving datapath: a request at a time, in
numpy, from the configuration file alone.

It replays a run tick by tick from what was submitted before each tick
and the policy draws the benchmark made, and keeps what the program's
host and device would show: the order of each tick's admission batch,
each request's lane, slot, admission, completion, retries and drop, the
(instances, slots) pool, the endpoints' loads and health EWMAs, the
per-service counters and the count of active slots.

Semantics (the XLB datapath as documented for users, written out here
one request at a time):

* ingress: header fields hashed (31-bit FNV-1a) into feature columns;
  the ready queue is first in, first out; a held request waits
  ``min(base << (retries - 1), cap)`` ticks plus a jitter drawn from
  ``default_rng((backoff_seed, req_id, retries))`` below that delay, is
  dropped once it has been held ``max_retries`` times, and goes back to
  the front of the queue when its wait is over (earliest first);
* admission, each row of the batch in order: the first rule of the
  request's service whose feature column equals the rule's hash (or any,
  for a wildcard) names the cluster, else the request has no route; the
  policy picks one of the cluster's eligible endpoints: least_request the
  first of least load, counting the rows before it in the batch;
  weighted the largest log(weight + 1e-9) + Gumbel noise of the row's
  window lane; round robin the cluster's cursor plus the earlier rows of
  the batch for the cluster; random ``rnd`` modulo the eligible count;
  the request takes the k-th slot of its instance that was free when the
  tick began, where k counts the rows before it that chose the instance,
  or is held; every admitted row counts its service's request and bytes;
* completion, every tick after admission: each active slot grows by one
  token, and is done at ``max_len - 1`` tokens; done slots release their
  endpoint's load and free the slot; each active slot adds 2 rx bytes to
  its service; the EWMAs step ``x + a * (obs - x)`` in float32 with the
  load before the releases (a = 1/4) and the completions (a = 1/8).
"""

from __future__ import annotations

import collections
import heapq

import numpy as np

from xlbench.reference.fnv import features, fnv1a

RX_BYTES_PER_TOKEN = 2
ALPHA_INFLIGHT = np.float32(0.25)
ALPHA_TPUT = np.float32(0.125)


class Req:
    __slots__ = ("rid", "svc", "feats", "nbytes", "retries", "admit_tick",
                 "done_tick", "dropped", "lane", "slot")

    def __init__(self, rid, svc, headers, nbytes):
        self.rid, self.svc = rid, svc
        self.feats = features(headers)
        self.nbytes = nbytes
        self.retries, self.admit_tick, self.done_tick = 0, -1, -1
        self.dropped, self.lane, self.slot = False, -1, -1


class Datapath:
    """One deployment's datapath, replayed a tick at a time."""

    def __init__(self, lay, *, slots: int, max_len: int, eos: int,
                 admit_batch: int, max_retries: int, backoff_base: int,
                 backoff_cap: int, backoff_seed: int, sizes: dict):
        if eos >= 0:
            raise ValueError("the reference replays length-driven "
                             "completion only (eos < 0)")
        self.lay = lay
        self.I, self.C = lay.lanes, slots
        self.max_len, self.R = max_len, admit_batch
        self.max_retries, self.base, self.cap = (max_retries, backoff_base,
                                                 backoff_cap)
        self.backoff_seed = backoff_seed
        E, S, CL = sizes["E"], sizes["S"], sizes["CL"]
        self.E, self.S, self.CL = E, S, CL
        self.ep_lane = np.array(lay.endpoint_lanes, np.int64)
        starts, c0 = [], 0
        for c in lay.clusters:
            starts.append(c0)
            c0 += len(c.endpoints)
        self.cl_start = starts
        I, C = self.I, self.C
        self.p_rid = np.full((I, C), -1, np.int64)
        self.p_ep = np.full((I, C), -1, np.int64)
        self.p_svc = np.zeros((I, C), np.int64)
        self.p_len = np.zeros((I, C), np.int64)
        self.p_act = np.zeros((I, C), bool)
        self.ep_load = np.zeros(E, np.int64)
        self.rr = np.zeros(CL, np.int64)
        self.ew_in = np.zeros(E, np.float32)
        self.ew_tp = np.zeros(E, np.float32)
        self.requests = np.zeros(S, np.int64)
        self.tx = np.zeros(S, np.int64)
        self.rx = np.zeros(S, np.int64)
        self.no_route = 0
        self.overflow = 0
        self.reqs: dict[int, Req] = {}
        self.queue: collections.deque = collections.deque()
        self.waiting: list = []
        self.wseq = 0
        self.tick_no = 0

    # ------------------------------------------------------------------ #
    def submit(self, rid, svc, headers, token, nbytes) -> None:
        """A call sent before the next tick (its prompt token plays no part
        in routing)."""
        r = Req(rid, svc, headers, nbytes)
        self.reqs[rid] = r
        self.queue.append(r)

    def _backoff(self, r: Req) -> None:
        if r.retries >= self.max_retries:
            r.dropped = True
            return
        delay = min(self.base << (r.retries - 1), self.cap)
        g = np.random.default_rng((self.backoff_seed, r.rid, r.retries))
        delay += int(g.integers(0, delay))
        heapq.heappush(self.waiting, (self.tick_no + delay, self.wseq, r))
        self.wseq += 1

    def _route(self, r: Req):
        """(cluster, eligible endpoints) of the request; cluster -1 = no
        rule matched."""
        if not 0 <= r.svc < len(self.lay.services):
            return -1, []
        for col, value, cl in self.lay.rules[r.svc]:
            if value is None or r.feats[col] == _hash(value):
                start = self.cl_start[cl]
                n = len(self.lay.clusters[cl].endpoints)
                return cl, list(range(start, start + n))
        return -1, []

    def _pick(self, cl: int, elig: list, rank_c: int, rnd: int, gum):
        policy = self.lay.clusters[cl].policy
        if policy == "least_request":
            loads = self.ep_load[elig]
            return elig[int(np.argmin(loads))]
        if policy == "weighted":
            c = self.lay.clusters[cl]
            w = np.asarray(c.weights, np.float32)
            score = np.log(w + np.float32(1e-9)).astype(np.float32) \
                + gum[:len(elig)]
            return elig[int(np.argmax(score))]
        if policy == "round_robin":
            return elig[int((self.rr[cl] + rank_c) % len(elig))]
        if policy == "random":
            return elig[int(rnd % len(elig))]
        raise ValueError(f"the reference has no policy {policy!r}")

    # ------------------------------------------------------------------ #
    def tick(self, draws) -> dict:
        """One tick.  ``draws()`` gives the next admission's (rnd, gumbel)
        as numpy arrays; it is called only on a tick whose batch holds a
        request.  Returns what the tick showed: the batch's ids in order,
        the (I, C) ids that decoded, the active count, and the work."""
        t = self.tick_no
        ready = []
        while self.waiting and self.waiting[0][0] <= t:
            ready.append(heapq.heappop(self.waiting)[2])
        self.queue.extendleft(reversed(ready))
        admitted: set = set()
        taken = [self.queue.popleft()
                 for _ in range(min(self.R, len(self.queue)))]
        work = {"rows": len(taken), "svc": [], "cluster": [], "ep": [],
                "ok": [], "policy": []}
        if taken:
            rnd, gum = draws()
            free = ~self.p_act
            inst_count = collections.Counter()
            cl_count = collections.Counter()
            held_e = collections.Counter()
            for j, r in enumerate(taken):
                cl, elig = self._route(r)
                work["svc"].append(r.svc)
                work["cluster"].append(cl)
                if cl < 0:
                    self.no_route += 1
                    work["ep"].append(-1)
                    work["ok"].append(False)
                    work["policy"].append(None)
                    continue
                work["policy"].append(self.lay.clusters[cl].policy)
                ep = self._pick(cl, elig, cl_count[cl], int(rnd[j]), gum[j])
                self.ep_load[ep] += 1
                cl_count[cl] += 1
                lane = int(self.ep_lane[ep])
                k = inst_count[lane]
                inst_count[lane] += 1
                slots = np.flatnonzero(free[lane])
                work["ep"].append(ep)
                if k < len(slots):
                    s = int(slots[k])
                    self.p_rid[lane, s], self.p_ep[lane, s] = r.rid, ep
                    self.p_svc[lane, s], self.p_len[lane, s] = r.svc, 0
                    self.p_act[lane, s] = True
                    r.lane, r.slot = lane, s
                    admitted.add(r.rid)
                    if 0 <= r.svc < self.S:
                        self.requests[r.svc] += 1
                        self.tx[r.svc] += r.nbytes
                    work["ok"].append(True)
                else:
                    held_e[ep] += 1
                    self.overflow += 1
                    work["ok"].append(False)
            for ep, n in held_e.items():
                self.ep_load[ep] -= n
            for cl, n in cl_count.items():
                self.rr[cl] += n
        ids = self.p_rid.copy()
        # completion
        act = self.p_act
        work["valid_keys"] = int(np.minimum(self.p_len + 1,
                                            self.max_len).sum())
        new_len = np.where(act, self.p_len + 1, self.p_len)
        done = act & (new_len >= self.max_len - 1)
        occ = self.ep_load.astype(np.float32)
        dec = np.bincount(self.p_ep[done], minlength=self.E)
        svc = self.p_svc[act]
        svc = svc[svc < self.S]
        self.rx += RX_BYTES_PER_TOKEN * np.bincount(svc, minlength=self.S)
        self.ew_in = self.ew_in + ALPHA_INFLIGHT * (occ - self.ew_in)
        self.ew_tp = self.ew_tp + ALPHA_TPUT * (dec.astype(np.float32)
                                               - self.ew_tp)
        self.ep_load -= dec
        for rid in self.p_rid[done]:
            self.reqs[int(rid)].done_tick = t
        self.p_rid[done], self.p_ep[done], self.p_len[done] = -1, -1, 0
        self.p_len[act & ~done] = new_len[act & ~done]
        self.p_act = act & ~done
        for rid in ids[ids >= 0]:
            r = self.reqs[int(rid)]
            if r.admit_tick < 0:
                r.admit_tick = t
        for r in taken:
            if r.rid not in admitted:
                r.retries += 1
                self._backoff(r)
        self.tick_no += 1
        return {"batch": [r.rid for r in taken], "ids": ids,
                "active": int(self.p_act.sum()), "work": work}

    def final_state(self) -> dict:
        return {"pool.req_id": self.p_rid, "pool.endpoint": self.p_ep,
                "pool.svc": self.p_svc, "pool.length": self.p_len,
                "pool.active": self.p_act, "routing.ep_load": self.ep_load,
                "routing.rr_cursor": self.rr % np.maximum(
                    self._cluster_counts(), 1),
                "routing.ep_inflight_ewma": self.ew_in,
                "routing.ep_tput_ewma": self.ew_tp,
                "metrics.requests": self.requests, "metrics.tx_bytes": self.tx,
                "metrics.rx_bytes": self.rx,
                "metrics.no_route_match": np.int64(self.no_route),
                "metrics.overflow": np.int64(self.overflow)}

    def _cluster_counts(self) -> np.ndarray:
        n = np.zeros(self.CL, np.int64)
        for i, c in enumerate(self.lay.clusters):
            n[i] = len(c.endpoints)
        return n


_HASHES: dict = {}


def _hash(value: str) -> int:
    h = _HASHES.get(value)
    if h is None:
        h = _HASHES[value] = fnv1a(value)
    return h
