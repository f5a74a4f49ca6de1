"""The closed loop of clients that drives `ServingEngine.submit` and
`ServingEngine.step`, and the host-clock record of every token.

After each `step()` (which waits for the step's tokens: the engine
copies them to the host) the loop reads the clock once: every token the
step produced is stamped with that time, the first token of a request
with the engine's own `t_first` mark (taken at its prefill, inside the
step).  A client whose reply completed sends its next request at once.
"""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class Rec:
    """One request as the harness saw it."""
    client: int
    index: int            # the traffic stream's item index
    prompt: object        # np.ndarray (int32)
    output_len: int
    req: object           # the engine's Request
    times: list = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return bool(self.req.done)

    @property
    def ok(self) -> bool:
        """Finished as asked: every drawn output token, by its length."""
        return (self.req.finish_reason == "max_new_tokens"
                and len(self.req.out_tokens) == self.output_len)


class StallError(RuntimeError):
    pass


class ClosedLoop:
    """N clients over one engine (N = the engine's slots)."""

    def __init__(self, engine, traffic, request_cls, clock=time.monotonic):
        self.eng = engine
        self.traffic = traffic
        self.request_cls = request_cls
        self.clock = clock
        engine.clock = clock
        self.recs: list[Rec] = []
        self.active: dict[int, Rec] = {}
        self.sent = [0] * traffic.clients
        self.steps = 0

    def _submit(self, client: int, item) -> None:
        prompt = self.traffic.prompt(item)
        req = self.request_cls(rid=item.index, prompt=prompt, max_new_tokens=item.output_len,
                               temperature=float(self.traffic.mix.get("temperature", 0.0)))
        rec = Rec(client, item.index, prompt, item.output_len, req)
        self.recs.append(rec)
        self.active[client] = rec
        self.eng.submit(req)

    def start(self) -> None:
        """Every client sends its warm-up request."""
        for c, item in enumerate(self.traffic.warmup):
            self._submit(c, item)

    def step(self) -> list[int]:
        """One engine step; stamps its tokens, resubmits for every client
        whose reply completed and returns those clients."""
        self.eng.step()
        self.steps += 1
        now = self.clock()
        if self.eng.health.get("nan_detected"):
            raise StallError("the engine's guard saw non-finite logits")
        done = []
        for c, rec in list(self.active.items()):
            out = rec.req.out_tokens
            while len(rec.times) < len(out):
                rec.times.append(rec.req.t_first if not rec.times else now)
            if rec.req.done:
                del self.active[c]
                done.append(c)
        for c in done:
            self.sent[c] += 1
            self._submit(c, self.traffic.client_item(c, self.sent[c]))
        return done

    def warm_up(self, limit_s: float) -> None:
        """Steps until every client has finished at least one request."""
        t0 = self.clock()
        while min(self.sent) == 0:
            self.step()
            if self.clock() - t0 > limit_s:
                raise StallError(f"warm-up passed {limit_s} s")

    def run_for(self, seconds: float) -> tuple[float, float, int]:
        """Steps for `seconds` (the last step ends past it): (opened,
        closed, steps)."""
        t_open = self.clock()
        s0 = self.steps
        while self.clock() - t_open < seconds:
            self.step()
        return t_open, self.clock(), self.steps - s0
