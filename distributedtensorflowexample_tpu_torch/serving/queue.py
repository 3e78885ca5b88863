"""Request queue + continuous batcher: admission at step boundaries,
never batch-drain.

The naive serving loop forms a batch, decodes it to completion, then
admits the next batch — so a 4-token request arriving behind a
500-token one waits the whole long decode.  Continuous batching admits
a new request into any OPEN slot at the next step boundary: the decode
step's shape is static (all S slots compute every step), so joining a
running batch costs one bucketed prefill, not a drain.  The engine's
slot math is batch-independent by construction (serving/engine.py), so
a mid-decode admission cannot perturb the requests already in flight —
tests/test_torch_serving.py pins that a request admitted mid-decode
produces bitwise the tokens it produces solo.

Admission is SLO-aware (``SERVE_SLO_MS``, 0 = off): a queued request is
priced at admission time — wait so far + a prefill estimate + max_new x
the decode-step EWMA — and one that can no longer finish inside the SLO
is REJECTED loudly (counted, latency-stamped) instead of admitted to
miss.  Under overload a closed-loop client sees fast rejections and the
in-SLO goodput stays measurable; that rejection edge is exactly the
knee a serving benchmark's throughput-vs-SLO curves sweep out.

Shutdown is the trainer's loss-free TERM protocol, re-read for serving:
on ``drain()`` the batcher stops admitting, decodes every in-flight
slot to completion (bounded by each request's max_new), rejects the
still-queued tail (outcome ``drained`` — the client's cue to retry
against the next placement), and returns — the worker then exits 143
with every ACCEPTED-and-admitted request answered.  Telemetry flows
through the shared obs registry: queue depth, slot occupancy,
tokens/sec counters, a latency histogram, and p50/p99 gauges refreshed
from the exact host-side tape.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
import time

import numpy as np

from distributedtensorflowexample_tpu_torch.obs import metrics as obs_metrics
from distributedtensorflowexample_tpu_torch.obs import trace as obs_trace
from distributedtensorflowexample_tpu_torch.refusal import ModeRefusal
from distributedtensorflowexample_tpu_torch.serving.engine import DecodeEngine
from distributedtensorflowexample_tpu_torch.serving.promote import as_prompt

_REQUESTS = obs_metrics.counter(
    "serve_requests_total", "serving requests by outcome "
    "(ok / slo_rejected / drained / refused / oov_refused / "
    "bad_request)")
_TOKENS = obs_metrics.counter(
    "serve_tokens_total", "tokens generated (completed requests only)")
_STEPS = obs_metrics.counter(
    "serve_decode_steps_total", "decode steps executed")
_PREFILLS = obs_metrics.counter(
    "serve_prefills_total", "bucketed prefill calls, by bucket")
_QUEUE_DEPTH = obs_metrics.gauge(
    "serve_queue_depth", "requests queued, not yet admitted to a slot")
_SLOTS_BUSY = obs_metrics.gauge(
    "serve_slots_busy", "decode slots holding a live request")
_LATENCY = obs_metrics.histogram(
    "serve_latency_seconds", "request end-to-end latency (submit to "
    "last token)")
_P50 = obs_metrics.gauge(
    "serve_latency_p50_ms", "rolling p50 of completed-request latency")
_P99 = obs_metrics.gauge(
    "serve_latency_p99_ms", "rolling p99 of completed-request latency")


def serve_slo_ms_default() -> float:
    """``SERVE_SLO_MS``: default end-to-end latency SLO driving
    admission (0 = admit everything; CLI flags override)."""
    try:
        return float(os.environ.get("SERVE_SLO_MS", ""))
    except ValueError:
        return 0.0


def recent_p99_ms(completed: list, window: int = 32) -> float | None:
    """p99 (ms) over the newest ``window`` completed requests — the
    remediation layer's breach/recovery signal.  Whole-tape percentiles
    (``stats()``) never recover from an early bad episode; a windowed
    read answers "is it still slow NOW", which is what an SLO-tighten
    decision (and its verification) needs."""
    tape = sorted(r.latency_s for r in completed[-window:]
                  if r.latency_s is not None)
    if not tape:
        return None
    return round(percentile(tape, 0.99) * 1000.0, 3)


def percentile(sorted_vals: list, q: float) -> float:
    """Nearest-rank percentile over an already-sorted list (exact, no
    interpolation surprises in records)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return float(sorted_vals[idx])


@dataclasses.dataclass
class Request:
    """One generation request and its whole lifecycle tape."""
    rid: str
    prompt: np.ndarray
    max_new: int
    submit_t: float
    admit_t: float | None = None
    first_token_t: float | None = None
    done_t: float | None = None
    outcome: str = ""           # ok | slo_rejected | drained | refused
    error: str = ""             # the refusal text, when refused
    tokens: list = dataclasses.field(default_factory=list)
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)

    @property
    def latency_s(self) -> float | None:
        if self.done_t is None:
            return None
        return self.done_t - self.submit_t

    def finish(self, outcome: str, now: float) -> None:
        self.outcome = outcome
        self.done_t = now
        self.done.set()


class RequestQueue:
    """Thread-safe FIFO between submitters (loadgen threads, the HTTP
    front) and the single batcher thread.  OOV prompts are refused at
    ``submit`` — by name, before the queue ever sees them."""

    def __init__(self, vocab: int):
        self.vocab = vocab
        self._q: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._seq = 0
        self._closed = False

    def __len__(self) -> int:
        with self._cv:
            return len(self._q)

    def submit(self, prompt, max_new: int, rid: str | None = None,
               now: float | None = None) -> Request:
        try:
            arr = as_prompt(prompt, self.vocab)
        except ModeRefusal:
            _REQUESTS.labels(outcome="oov_refused").inc()
            raise
        except ValueError:
            # Shape/dtype defects, not vocabulary: an operator tuning
            # a tokenizer off the oov counter must not chase these.
            _REQUESTS.labels(outcome="bad_request").inc()
            raise
        with self._cv:
            self._seq += 1
            req = Request(rid=rid or f"req{self._seq}", prompt=arr,
                          max_new=int(max_new),
                          submit_t=time.monotonic() if now is None
                          else now)
            if self._closed:
                # A submit racing the drain (TERM already landed) is
                # answered immediately — a worker on its way out must
                # never leave a caller blocked on a request nothing
                # will ever decode.
                req.finish("drained", time.monotonic())
                _REQUESTS.labels(outcome="drained").inc()
                return req
            self._q.append(req)
            _QUEUE_DEPTH.set(len(self._q))
            self._cv.notify_all()
        return req

    def close(self) -> None:
        """Stop accepting work: every later submit is answered
        ``drained`` synchronously (the drain path calls this FIRST, so
        the submit/drain race cannot strand a waiter)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def pop(self) -> Request | None:
        with self._cv:
            req = self._q.popleft() if self._q else None
            _QUEUE_DEPTH.set(len(self._q))
            return req

    def drain_pending(self) -> list:
        with self._cv:
            out = list(self._q)
            self._q.clear()
            _QUEUE_DEPTH.set(0)
            return out

    def wait_nonempty(self, timeout_s: float) -> bool:
        with self._cv:
            if self._q:
                return True
            self._cv.wait(timeout_s)
            return bool(self._q)


@dataclasses.dataclass
class _Slot:
    req: Request | None = None


class ContinuousBatcher:
    """The serving loop: admit → decode → retire, one step boundary at
    a time, on one thread (the engine's in-place caches are single-
    writer by construction — concurrency lives in the queue, never in
    the device state)."""

    def __init__(self, engine: DecodeEngine, queue: RequestQueue, *,
                 slo_ms: float | None = None, eos_id: int | None = None,
                 on_step=None, spec=None, sampler=None,
                 prefix_cache=None):
        if spec is not None and sampler is not None:
            raise ModeRefusal(
                "--sample_temp/--sample_top_k cannot combine with "
                "--spec_draft: speculative acceptance compares "
                "bitwise-GREEDY tokens against the draft (the oracle "
                "contract), and a sampled token has no greedy oracle — "
                "run one or the other")
        if sampler is not None and not hasattr(engine, "decode_logits"):
            raise ModeRefusal(
                "--sample_temp/--sample_top_k need the engine's "
                "logits-returning decode seam, which the "
                "params-stay-sharded engine (--sharded_mesh) does not "
                "expose — sampling composes with the replicated path "
                "only")
        self.engine = engine
        self.queue = queue
        self.slo_ms = serve_slo_ms_default() if slo_ms is None \
            else float(slo_ms)
        self.eos_id = eos_id
        self.on_step = on_step          # per-boundary callback (heartbeat)
        self.spec = spec                # SpecDecoder (serving/spec.py)
        self.sampler = sampler          # Sampler (serving/sampling.py)
        self.prefix_cache = prefix_cache  # PrefixCache (serving/prefix.py)
        self._slots = [_Slot() for _ in range(engine.slots)]
        # Step-time EWMA feeding the admission predictor; seeded on the
        # first measured step (the first step is excluded — it pays the
        # card's lazy kernel loading, which would poison the estimate and
        # reject everything for a while).
        self._step_ewma_s: float | None = None
        self._prefill_ewma_s: float | None = None
        self.completed: list = []       # finished Requests (tape)
        self.rejected: list = []
        self.admitted_total = 0

    def set_slo_ms(self, slo_ms: float) -> float:
        """The remediation seam (resilience/remediate.py's slo_tighten
        actuator): swap the live admission SLO and return the previous
        value.  ``slo_ms`` is read per-admission, so the change takes
        effect at the next step boundary — no drain, no restart, and
        requests already admitted are unaffected (tightening admission
        must never drop admitted work)."""
        was, self.slo_ms = self.slo_ms, float(slo_ms)
        return was

    # --- admission --------------------------------------------------------
    def _predicted_latency_s(self, req: Request, now: float) -> float:
        wait = now - req.submit_t
        pre = self._prefill_ewma_s or 0.0
        step = self._step_ewma_s or 0.0
        return wait + pre + req.max_new * step

    def _free_slots(self) -> list:
        return [i for i, s in enumerate(self._slots) if s.req is None]

    def _admit(self, now: float) -> None:
        """Fill open slots from the queue head; SLO-reject requests
        that can no longer finish in time (they would only burn slot
        capacity to miss).  Admissions passing the gates are collected
        and prefilled as ONE batch per padding bucket
        (``engine.prefill_many`` — the burst-amortization rung)."""
        free = self._free_slots()
        batch: list = []
        while free and len(self.queue):
            req = self.queue.pop()
            if req is None:
                break
            try:
                # Geometry check BEFORE the slot is spent: a request
                # that can never finish inside the cache is refused by
                # name — one impossible request must cost itself, never
                # the serving loop (the batcher thread has no other
                # handler above it).
                self.engine.bucket_for(len(req.prompt), req.max_new)
            except ValueError as e:
                req.error = str(e)
                req.finish("refused", time.monotonic())
                _REQUESTS.labels(outcome="refused").inc()
                self.rejected.append(req)
                continue
            if self.slo_ms > 0 and self._predicted_latency_s(
                    req, now) * 1000.0 > self.slo_ms:
                req.finish("slo_rejected", time.monotonic())
                _REQUESTS.labels(outcome="slo_rejected").inc()
                self.rejected.append(req)
                continue
            batch.append((free.pop(0), req))
        if batch:
            self._prefill_batch(batch)
        _SLOTS_BUSY.set(self.engine.slots - len(self._free_slots()))

    def _prefill_batch(self, batch: list) -> None:
        """Admit ``batch`` = [(slot, req), ...]: prefix-cache probes
        first (a hit skips the forward entirely), the remaining misses
        in one bucketed ``prefill_many`` call, then per-request
        bookkeeping (first token — sampled when a sampler is armed —
        tracing spans, draft-engine prefill for speculation)."""
        served: dict = {}                 # slot -> (first, logits, outcome)
        todo: list = []
        for slot, req in batch:
            hit = None if self.prefix_cache is None \
                else self.prefix_cache.admit(slot, req.prompt)
            if hit is not None:
                served[slot] = hit
            else:
                todo.append((slot, req))
        t0 = time.monotonic()
        if todo:
            out = self.engine.prefill_many(
                [(slot, req.prompt, req.max_new) for slot, req in todo])
            dt = time.monotonic() - t0
            # The first prefill per bucket pays the card's lazy kernel
            # loading — a wall time far above steady state that must never
            # seed the admission predictor (a warm-up-poisoned EWMA
            # under an SLO rejects everything, and with nothing
            # admitted it never decays back: a livelock).  The EWMA
            # tracks PER-REQUEST cost, so batched admissions make the
            # predictor cheaper, as measured.
            if not self.engine.last_prefill_was_cold:
                per = dt / len(todo)
                self._prefill_ewma_s = per \
                    if self._prefill_ewma_s is None \
                    else 0.8 * self._prefill_ewma_s + 0.2 * per
            for slot, req in todo:
                first, last = out[slot]
                served[slot] = (first, last, "prefill")
                if self.prefix_cache is not None:
                    self.prefix_cache.register(slot, req.prompt, first,
                                               last)
                _PREFILLS.labels(
                    bucket=self.engine.bucket_for(len(req.prompt),
                                                  req.max_new)).inc()
        prefill_dt = time.monotonic() - t0
        for slot, req in batch:
            first, last, outcome = served[slot]
            if self.sampler is not None:
                # Even the first token is sampled (index 0 of the
                # request's RNG lane) — the prefill seam hands back the
                # last position's logits for exactly this.
                first = self.sampler.sample(req.rid, 0, last)
                self.engine.set_slot(slot, first,
                                     int(self.engine.positions[slot]))
            req.admit_t = req.first_token_t = time.monotonic()
            obs_trace.event("serve_queue", req.admit_t - req.submit_t,
                            t0_s=req.submit_t, rid=req.rid, slot=slot)
            obs_trace.event("serve_prefill", prefill_dt, t0_s=t0,
                            rid=req.rid, slot=slot, outcome=outcome,
                            batch=len(todo))
            req.tokens.append(int(first))
            self._slots[slot].req = req
            self.admitted_total += 1
            if self.spec is not None:
                self.spec.on_admit(slot, req.prompt, req.max_new)
            # max_new == 1 finishes on the prefill's own token.
            self._maybe_retire(slot, time.monotonic())

    def _maybe_retire(self, slot: int, now: float) -> bool:
        req = self._slots[slot].req
        if req is None:
            return True
        full = len(req.tokens) >= req.max_new
        eos = self.eos_id is not None and req.tokens \
            and req.tokens[-1] == self.eos_id
        if not (full or eos):
            return False
        req.finish("ok", now)
        _REQUESTS.labels(outcome="ok").inc()
        _TOKENS.inc(len(req.tokens))
        _LATENCY.observe(req.latency_s)
        t0 = req.first_token_t if req.first_token_t is not None else now
        obs_trace.event("serve_decode", now - t0, t0_s=t0, rid=req.rid,
                        slot=slot, tokens=len(req.tokens),
                        outcome=req.outcome)
        self.completed.append(req)
        self._slots[slot].req = None
        # Park the freed slot's frontier at 0: idle slots still compute
        # every step, and an unbounded frontier would walk past the
        # positional table for nothing.
        self.engine.set_slot(slot, 0, 0)
        if self.spec is not None:
            self.spec.park(slot)
        if len(self.completed) % 32 == 0 or len(self.completed) < 8:
            tape = sorted(r.latency_s for r in self.completed)
            _P50.set(round(percentile(tape, 0.50) * 1000.0, 3))
            _P99.set(round(percentile(tape, 0.99) * 1000.0, 3))
        return True

    # --- the loop ---------------------------------------------------------
    def _busy(self) -> list:
        return [i for i, s in enumerate(self._slots) if s.req is not None]

    def _note_step_time(self, dt: float) -> None:
        # The engine's FIRST decode step pays the warm-up — never let
        # it seed the admission predictor (see the prefill comment:
        # a warm-up-poisoned EWMA under an SLO is a reject-everything
        # livelock, because nothing admitted means nothing ever decays
        # it).  Once seeded, a 50x outlier is skipped.
        # Under speculation dt is a whole round (>= 1 emitted token per
        # slot), so max_new x EWMA stays a conservative upper bound.
        if self.engine.decode_steps > 1:
            if self._step_ewma_s is None:
                self._step_ewma_s = dt
            elif dt < 50 * self._step_ewma_s:
                self._step_ewma_s = 0.8 * self._step_ewma_s + 0.2 * dt

    def _decode_once(self) -> int:
        """One decode boundary over the busy slots, dispatched by mode:
        a speculative round (draft k, verify once, emit 1..k+1 tokens
        per slot), a sampled step (logits out, host draws each token on
        its request's RNG lane), or the default greedy fused-argmax
        step.  Retires whatever finished.  Returns live slots decoded."""
        busy = self._busy()
        if not busy:
            return 0
        t0 = time.monotonic()
        if self.spec is not None:
            remaining = {
                s: self._slots[s].req.max_new - len(self._slots[s].req.tokens)
                for s in busy}
            emitted = self.spec.round(busy, remaining)
            self._note_step_time(time.monotonic() - t0)
            _STEPS.inc()
            now = time.monotonic()
            for slot in busy:
                toks = emitted[slot]
                if self.eos_id is not None and self.eos_id in toks:
                    # Plain greedy stops AT eos; a round must not hand
                    # the request tokens greedy would never have
                    # produced (the oracle contract).
                    toks = toks[:toks.index(self.eos_id) + 1]
                self._slots[slot].req.tokens.extend(toks)
                self._maybe_retire(slot, now)
        elif self.sampler is not None:
            logits = self.engine.decode_logits(busy=busy)
            self._note_step_time(time.monotonic() - t0)
            _STEPS.inc()
            now = time.monotonic()
            for slot in busy:
                req = self._slots[slot].req
                tok = self.sampler.sample(req.rid, len(req.tokens),
                                          logits[slot])
                self.engine.set_slot(slot, tok,
                                     int(self.engine.positions[slot]))
                req.tokens.append(tok)
                self._maybe_retire(slot, now)
        else:
            toks = self.engine.decode(busy=busy)
            self._note_step_time(time.monotonic() - t0)
            _STEPS.inc()
            now = time.monotonic()
            for slot in busy:
                req = self._slots[slot].req
                req.tokens.append(int(toks[slot]))
                self._maybe_retire(slot, now)
        _SLOTS_BUSY.set(self.engine.slots - len(self._free_slots()))
        return len(busy)

    def step(self) -> int:
        """One boundary: admit into open slots, one decode boundary
        over the batch, retire finished requests.  Returns the number
        of live slots decoded (0 = idle boundary)."""
        self._admit(time.monotonic())
        n = self._decode_once()
        if n == 0:
            return 0
        if self.on_step is not None:
            self.on_step(self)
        return n

    def run(self, should_stop=lambda: False,
            idle_wait_s: float = 0.02) -> None:
        """Serve until ``should_stop()`` — then drain (see module
        docstring).  Idle boundaries block on the queue's condition
        variable, so an idle worker burns no CPU busy-looping the
        decode step against zero slots."""
        while not should_stop():
            if self.step() == 0:
                self.queue.wait_nonempty(idle_wait_s)
        self.drain()

    def drain(self) -> None:
        """The TERM half of loss-free teardown: stop admitting, decode
        every in-flight request to completion, reject the queued tail
        loudly (outcome ``drained`` — re-submittable against the next
        placement, never silently lost)."""
        t0 = time.monotonic()
        in_flight = len(self._busy())
        self.queue.close()           # later submits answer 'drained'
        now = time.monotonic()
        tail = self.queue.drain_pending()
        for req in tail:
            req.finish("drained", now)
            _REQUESTS.labels(outcome="drained").inc()
            obs_trace.event("serve_drain", now - req.submit_t,
                            t0_s=req.submit_t, rid=req.rid,
                            outcome="drained")
            self.rejected.append(req)
        # In-flight work decodes to completion through the SAME
        # per-boundary dispatch serving used — an in-flight speculative
        # batch keeps drafting+verifying mid-drain (its tokens are
        # greedy's tokens either way), a sampled batch keeps its RNG
        # lanes.
        while self._busy():
            self._decode_once()
        _SLOTS_BUSY.set(0)
        obs_trace.event("serve_drain", time.monotonic() - t0, t0_s=t0,
                        in_flight=in_flight, tail=len(tail))

    # --- stats ------------------------------------------------------------
    def stats(self) -> dict:
        tape = sorted(r.latency_s for r in self.completed)
        ttft = sorted(r.first_token_t - r.submit_t for r in self.completed)
        toks = sum(len(r.tokens) for r in self.completed)
        span = (max(r.done_t for r in self.completed)
                - min(r.submit_t for r in self.completed)) \
            if self.completed else 0.0
        return {
            "admitted": self.admitted_total,
            "completed": len(self.completed),
            "rejected": {
                "slo": sum(1 for r in self.rejected
                           if r.outcome == "slo_rejected"),
                "refused": sum(1 for r in self.rejected
                               if r.outcome == "refused"),
                "drained": sum(1 for r in self.rejected
                               if r.outcome == "drained")},
            "tokens": toks,
            "tokens_per_sec": round(toks / span, 3) if span else None,
            "p50_ms": round(percentile(tape, 0.50) * 1000.0, 3),
            "p99_ms": round(percentile(tape, 0.99) * 1000.0, 3),
            "ttft_p50_ms": round(percentile(ttft, 0.50) * 1000.0, 3),
            "ttft_p99_ms": round(percentile(ttft, 0.99) * 1000.0, 3),
            "decode_steps": self.engine.decode_steps,
            "prefills": self.engine.prefills,
            "slo_ms": self.slo_ms,
            "slots": self.engine.slots,
            "step_ewma_ms": (round(self._step_ewma_s * 1000.0, 3)
                             if self._step_ewma_s else None),
            "spec": None if self.spec is None else self.spec.stats(),
            "sampler": (None if self.sampler is None
                        else self.sampler.describe()),
            "prefix_cache": (None if self.prefix_cache is None
                             else self.prefix_cache.stats()),
        }
