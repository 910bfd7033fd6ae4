"""Bounded admission queue + compatibility-keyed batch pop (the port's
copy of the JAX package's ``serve/queue.py``, its chaos admission site
``serve.admit`` included).

One lock + condition guards a deque.  ``submit`` never blocks: at depth
it raises :class:`Rejected` immediately (backpressure is the client's
problem, unbounded memory growth is ours).  ``pop_batch`` is the worker
side: block for a leader, then coalesce same-key followers for at most
the batch window.  Requests with different keys are left in place for
other workers — the scan preserves arrival order per key.

Leader selection is deadline-aware (EDF) when ``deadline_ordering`` is
on: the earliest-deadline waiter leads, so tight deadlines dispatch
ahead of slack FIFO traffic instead of timing out behind it.  Starvation
is bounded, not assumed away: once the OLDEST waiter has queued longer
than ``age_bound_s`` it leads regardless of deadlines, so undeadlined
traffic always makes progress.

With a :class:`~.policy.QosPolicy` that arms ``weighted_fair``, the
leader pick becomes stride-scheduled across TENANTS (tenant = style =
the batch key's exemplar sha1): each tenant holds a running "pass"
value, the waiting tenant with the smallest pass leads, and its pass
advances by ``1 / priority`` of the picked request — so an
``interactive`` request (weight 4) costs its tenant a quarter of a
``background`` step, and a viral style with a thousand waiters still
only gets its fair share of leaders.  The aging bound applies on top
(a waiter older than ``age_bound_s`` leads unconditionally), and
same-key coalescing after the leader is unchanged — followers share
the leader's key, hence its tenant.  Without a policy the pick is the
plain EDF one.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

from image_analogies_tpu_torch import chaos
from image_analogies_tpu_torch.obs import metrics as obs_metrics
from image_analogies_tpu_torch.serve.policy import QosPolicy
from image_analogies_tpu_torch.serve.types import Rejected, Request


def _tenant(req: Request) -> str:
    """Tenant identity = the batch key's exemplar sha1 (the same
    derivation the cost ledger uses in serve/worker.py)."""
    return str(req.key[-1]) if req.key else ""


class AdmissionQueue:
    def __init__(self, depth: int, deadline_ordering: bool = False,
                 age_bound_s: float = 5.0,
                 qos: Optional[QosPolicy] = None):
        self._depth = depth
        self._deadline_ordering = deadline_ordering
        self._age_bound_s = age_bound_s
        self._weighted_fair = bool(qos and qos.weighted_fair)
        # Stride-scheduling pass values, kept only for tenants with
        # waiters (bounded by queue depth; pruned on every pick).
        self._passes: Dict[str, float] = {}
        self._items: collections.deque[Request] = collections.deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def submit(self, req: Request) -> None:
        # admission-layer fault injection (drills): a raising kind here
        # surfaces synchronously to the submitting client, like any other
        # admission refusal — never a half-enqueued request.
        chaos.site("serve.admit", request=req.request_id)
        with self._lock:
            if self._closed:
                obs_metrics.inc("serve.rejected")
                raise Rejected("shutting_down")
            if len(self._items) >= self._depth:
                obs_metrics.inc("serve.rejected")
                raise Rejected("queue_full")
            self._items.append(req)
            obs_metrics.inc("serve.accepted")
            obs_metrics.max_gauge("serve.queue_depth_peak", len(self._items))
            obs_metrics.set_gauge("serve.queue_depth", len(self._items))
            # notify_all: a window-waiting worker may consume a single
            # notify meant for a leader-waiting one and drop the wakeup.
            self._cond.notify_all()

    def _take_leader(self) -> Request:
        """Remove and return the leader (lock held, deque non-empty).

        FIFO by default; with deadline ordering the earliest-deadline
        waiter leads (ties + undeadlined keep arrival order), UNLESS the
        oldest waiter has aged past the bound — then it leads no matter
        what, so EDF reordering can delay it by at most the bound.
        """
        if self._weighted_fair and len(self._items) > 1:
            return self._take_leader_wf()
        if not self._deadline_ordering or len(self._items) == 1:
            return self._items.popleft()
        now = time.monotonic()
        oldest = min(range(len(self._items)),
                     key=lambda i: self._items[i].t_submit)
        if now - self._items[oldest].t_submit > self._age_bound_s:
            obs_metrics.inc("serve.aging_promotions")
            idx = oldest
        else:
            idx = min(range(len(self._items)),
                      key=lambda i: (
                          self._items[i].deadline
                          if self._items[i].deadline is not None
                          else float("inf"),
                          self._items[i].t_submit))
        return self._pop_at(idx)

    def _pop_at(self, idx: int) -> Request:
        """Remove and return item ``idx`` (lock held) via the rotate
        trick — deque has no O(1) mid-removal, but leaders are near the
        front in practice."""
        self._items.rotate(-idx)
        leader = self._items.popleft()
        self._items.rotate(idx)
        return leader

    def _best_of(self, indices: List[int]) -> int:
        """EDF (when armed) else arrival order, within one tenant's
        waiting indices (lock held)."""
        if not self._deadline_ordering:
            return min(indices, key=lambda i: self._items[i].t_submit)
        return min(indices, key=lambda i: (
            self._items[i].deadline
            if self._items[i].deadline is not None else float("inf"),
            self._items[i].t_submit))

    def _take_leader_wf(self) -> Request:
        """Stride-scheduled leader pick across tenants (lock held).

        The aging bound still trumps fairness — a waiter older than
        ``age_bound_s`` leads no matter whose turn it is, so weighted
        fairness can reorder, never starve."""
        now = time.monotonic()
        oldest = min(range(len(self._items)),
                     key=lambda i: self._items[i].t_submit)
        if now - self._items[oldest].t_submit > self._age_bound_s:
            obs_metrics.inc("serve.aging_promotions")
            return self._pop_at(oldest)
        waiting: Dict[str, List[int]] = {}
        for i, req in enumerate(self._items):
            waiting.setdefault(_tenant(req), []).append(i)
        # New tenants join at the current floor: no credit for having
        # been absent, no penalty for being late to the party.
        floor = min((self._passes[t] for t in waiting
                     if t in self._passes), default=0.0)
        for t in waiting:
            self._passes.setdefault(t, floor)
        tenant = min(waiting, key=lambda t: (self._passes[t],
                                             min(waiting[t])))
        idx = self._best_of(waiting[tenant])
        leader = self._items[idx]
        self._passes[tenant] += 1.0 / max(1, int(leader.priority))
        # Prune pass state to tenants that still have waiters, so the
        # dict is bounded by queue depth, not tenant-lifetime history.
        self._passes = {t: v for t, v in self._passes.items()
                        if t in waiting}
        obs_metrics.inc("serve.wf_picks")
        return self._pop_at(idx)

    def pop_batch(self, max_batch: int, window_s: float) -> Optional[List[Request]]:
        """Return a batch of same-key requests, or None when closed+empty.

        The leader (see :meth:`_take_leader`) fixes the key; we then wait
        up to ``window_s`` for same-key followers, waking early whenever
        a new submit lands.  The leader is held outside the deque during the
        window, and the followers already queued are taken at once; but a
        follower that arrives while this worker waits out the window may be
        taken by another waiting worker as its own leader, which splits
        the key's burst (the JAX queue's behaviour, kept).
        """
        with self._lock:
            while not self._items:
                if self._closed:
                    return None
                self._cond.wait()
            leader = self._take_leader()
            batch = [leader]
            end = time.monotonic() + max(0.0, window_s)
            while len(batch) < max_batch:
                kept: collections.deque[Request] = collections.deque()
                for item in self._items:
                    if item.key == leader.key and len(batch) < max_batch:
                        batch.append(item)
                    else:
                        kept.append(item)
                self._items = kept
                if len(batch) >= max_batch or self._closed:
                    break
                remaining = end - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            now = time.monotonic()
            for req in batch:
                req.t_dequeue = now
                obs_metrics.observe("serve.queue_wait_ms",
                                    (now - req.t_submit) * 1e3)
            obs_metrics.set_gauge("serve.queue_depth", len(self._items))
            return batch

    def requeue(self, req: Request) -> None:
        """Put an already-admitted request back at the FRONT of the queue
        (crash containment).  Bypasses the depth bound on purpose — the
        request holds an admission slot it never released; rejecting it
        here would lose it.  Works even after close() so a crash during
        drain still resolves every future."""
        with self._lock:
            self._items.appendleft(req)
            obs_metrics.inc("serve.requeued")
            obs_metrics.set_gauge("serve.queue_depth", len(self._items))
            self._cond.notify_all()

    def restore(self, reqs: List[Request]) -> None:
        """Re-enqueue journal-replayed requests in their original admit
        order (recovery).  Like :meth:`requeue`, bypasses the depth bound:
        these requests were ALREADY admitted — by the previous incarnation
        of this process — and the journal is the witness; bouncing them
        here would lose accepted work, the exact failure the journal
        exists to prevent."""
        with self._lock:
            if not reqs:
                return
            self._items.extend(reqs)
            obs_metrics.max_gauge("serve.queue_depth_peak", len(self._items))
            obs_metrics.set_gauge("serve.queue_depth", len(self._items))
            self._cond.notify_all()

    def close(self) -> None:
        """Stop accepting; wake all workers so they can drain and exit."""
        with self._lock:
            self._closed = True
            self._cond.notify_all()

    def drain_rejected(self) -> List[Request]:
        """Dump any still-queued requests (non-draining shutdown)."""
        with self._lock:
            items = list(self._items)
            self._items.clear()
            self._cond.notify_all()
        return items
