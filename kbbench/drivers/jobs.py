"""Materialisation as a batch job, back to back.

Set-up generates the KB once, as host arrays, and runs one whole job,
which builds the kernels, fills the tuner's cache and warms every shape a
job uses.  The window then runs jobs back to back: each frees the previous
job's store, builds a new engine of the class the configuration's
``engine.class`` names, loads the dataset (compressing it into meta-facts)
and materialises it, and synchronises the device.  The window closes at
the end of the first job to finish after ``--seconds``.

``reason_facts_per_s`` is the facts in the closures of all jobs over the
time from the window's start to the end of the last job.  The check holds
every predicate's fact set of the last job's ``materialisation()``, and
every job's fact count, against the plain reference's closure.
"""

from __future__ import annotations

import gc
import time

from ..compare import fact_mismatches
from ..harness import Context, Outcome
from ..hostload import snapshot, uptime_s
from ..reference import flat
from ..spec import engine_name

__all__ = ["run"]


def run(ctx: Context) -> Outcome:
    import repro_torch.core as core
    from repro_torch.obs.memory import get_accountant

    kb = ctx.kb()
    ctx.log(f"KB generated (machine up {uptime_s():.0f} s)")
    program = core.parse_program(kb.program)
    engine = engine_name(ctx.config)
    engine_args = dict(ctx.config["engine"].get("args", {}))

    def job():
        try:
            cls = getattr(core, engine)  # at each job, so that the control can stand in
        except AttributeError:
            raise AttributeError(f"configuration {ctx.spec.cell['config']!r}: engine.class: "
                                 f"repro_torch.core has no {engine}") from None
        eng = cls(program, device=ctx.device, **engine_args)
        with ctx.spans.span("job.load"):
            eng.load(kb.dataset)
            ctx.sync()
        with ctx.spans.span("job.materialise"):
            stats = eng.materialise()
            ctx.sync()
        return eng, stats.n_facts

    with ctx.spans.span("setup.warm_job"):
        job()
    gc.collect()
    ctx.log("warm job")

    t0 = ctx.open_window()
    deadline = t0 + int(ctx.seconds * 1e9)
    facts: list[int] = []
    eng = None
    while True:
        with ctx.spans.span("job.free"):
            eng = None  # the previous job's store goes before the next is built
            gc.collect()
        before = snapshot()
        with ctx.spans.span("job"):
            eng, n = job()
        after = snapshot()
        facts.append(n)
        free, load, mat = (ctx.spans.spans[-k].dur_ns / 1e9 for k in (4, 3, 2))
        ctx.log(f"job {len(facts)}: {(after.wall_ns - before.wall_ns) / 1e9:.3f} s "
                f"(load {load:.3f} s, materialise {mat:.3f} s; free before it {free:.3f} s; "
                f"{after.since(before)})")
        if time.perf_counter_ns() >= deadline:
            break
    t1 = time.perf_counter_ns()
    ctx.log(f"window: {len(facts)} jobs")
    ctx.close_window(
        t1, jobs=len(facts), closure_facts=facts[-1],
        resident_bytes=get_accountant().resident_bytes(),
    )

    got = {p: r for p, r in eng.materialisation().items()}
    eng = None
    gc.collect()
    want = flat.closure(kb.program, kb.dataset, ctx.device)
    ctx.log("reference closure")
    n_want = sum(int(r.shape[0]) for r in want.values())
    return Outcome(
        end_to_end={"reason_facts_per_s": sum(facts) / ((t1 - t0) / 1e9)},
        attempted=len(facts),
        failed=0,
        checks={
            "fact_mismatches": (fact_mismatches(got, want), 0),
            "jobs_off_count": (sum(n != n_want for n in facts), 0),
        },
    )
