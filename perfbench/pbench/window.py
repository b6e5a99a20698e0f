"""The measured window: traffic offered to the server, each job timed.

Open loop: every job is submitted once it is due (the schedule is fixed
before the window opens) and timed from when it was due to the return of
the `step` that retired it; after the window the server runs on, with no
new work, until every job due in it has retired or ``grace_s`` has
passed.  Closed loop: ``outstanding`` jobs are in flight from the start
and every retirement submits the next.

In traced runs (``tracer``) the window also keeps the scheduler's spans,
the host time of the ladders' swap phase (`PTJob.on_segment` of the
benchmark's own jobs) and a profiler window of a few seconds around the
engine's launches (`trace.Window`).
"""

from __future__ import annotations

import time

from pbench import system


class Tracer:
    """What a traced run adds to the window."""

    def __init__(self, profile_s: float, window_factory):
        self.profile_s = profile_s
        self.factory = window_factory
        self.segments: list[tuple[float, float]] = []
        self.launches: list[tuple[float, int]] = []
        self.prof = None
        self.device: dict = {}

    def instrument(self, server) -> None:
        import torch

        eng, orig, launches = server.engine, server.engine.run, self.launches

        def run(carry, num_sweeps):
            launches.append((time.perf_counter(), int(num_sweeps)))
            with torch.profiler.record_function("pb.engine_run"):
                return orig(carry, num_sweeps)

        eng.run = run

    def wrap_job(self, job) -> None:
        if job.kind != "pt":
            return
        orig, spans = job.on_segment, self.segments

        def on_segment(server, carry, slots):
            a = time.perf_counter()
            try:
                return orig(server, carry, slots)
            finally:
                spans.append((a, time.perf_counter()))

        job.on_segment = on_segment

    def tick(self, now: float, t0: float, seconds: float) -> None:
        """Open the profiler window in the middle of the measured one and
        close it ``profile_s`` later."""
        start = t0 + max(0.0, (seconds - self.profile_s) / 2)
        if self.prof is None and now >= start:
            self.prof = self.factory()
            self.prof.start()
        elif self.prof is not None and self.prof.t_stop is None and now >= start + self.profile_s:
            self.prof.stop()

    def finish(self) -> None:
        if self.prof is not None:
            if self.prof.t_stop is None:
                self.prof.stop()
            self.device = self.prof.read()


def run(server, traffic, seconds: float, *, grace_s: float = 60.0, tracer: Tracer | None = None,
        step_hook=None) -> dict:
    """Offer ``traffic`` to ``server`` for ``seconds``; returns the window's
    record: its times, the counters at both ends, every job's times and the
    results of the jobs that retired.  ``step_hook(server)``, when given,
    runs before every step (tests inject stalls with it)."""
    clock = time.perf_counter
    jobs: dict[int, dict] = {}
    results: dict[int, object] = {}

    def submit(spec, due=None, index=None):
        job = system.make_job(spec)
        if tracer is not None:
            tracer.wrap_job(job)
        jid = server.submit(job)
        jobs[jid] = {"spec": spec, "index": index, "due": due, "submit": clock(), "done": None}
        return jid

    def step():
        if step_hook is not None:
            step_hook(server)
        done = server.step()
        t = clock()
        for r in done:
            jobs[r.jid]["done"] = t
            results[r.jid] = r
        if tracer is not None:
            tracer.tick(t, t0, seconds)
        return done

    c0 = system.counters(server)
    t0 = clock()
    deadline = t0 + seconds
    late = 0.0
    if traffic.loop == "open":
        queue = traffic.jobs
        k = 0
        while True:
            now = clock()
            if now >= deadline:
                break
            while k < len(queue) and t0 + queue[k]["due"] <= now:
                late = max(late, now - (t0 + queue[k]["due"]))
                submit(queue[k], due=t0 + queue[k]["due"], index=k)
                k += 1
            if server.num_active or server.num_queued:
                step()
            elif k < len(queue):
                time.sleep(max(0.0, min(t0 + queue[k]["due"], deadline) - clock()))
            else:
                time.sleep(max(0.0, min(deadline - clock(), 0.01)))
                if tracer is not None:
                    tracer.tick(clock(), t0, seconds)
        t1 = clock()
        c1 = system.counters(server)
        while k < len(queue):  # due before the close, not yet offered
            submit(queue[k], due=t0 + queue[k]["due"], index=k)
            k += 1
        end = t1 + grace_s
        while (server.num_active or server.num_queued) and clock() < end:
            step()
    else:
        k = 0
        for _ in range(traffic.outstanding):
            submit(traffic.spec(k), index=k)
            k += 1
        while clock() < deadline:
            for _ in step():
                submit(traffic.spec(k), index=k)
                k += 1
        t1 = clock()
        c1 = system.counters(server)
    if tracer is not None:
        tracer.finish()
    return {"t0": t0, "t1": t1, "seconds": seconds, "loop": traffic.loop, "counters": (c0, c1),
            "jobs": jobs, "results": results, "generator_late_s": late}
