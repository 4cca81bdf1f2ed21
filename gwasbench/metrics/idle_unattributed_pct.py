"""The card's idle time inside the jobs that no host stage accounts for:
of the traced window's time in the harness's ``job`` annotations when
no kernel, copy or set ran, the share under no program span on the
job's thread or under the root ``job`` span alone (its self time), %.
The program's spans are put on the trace's clock by
gwasbench/program_trace.py; the idle seconds a job by the innermost span
over them, longest first, go to the notes."""

from gwasbench.program_trace import idle_by_stage, window


def read(ctx):
    idle = idle_by_stage(ctx)
    if not idle:
        return None
    total = sum(idle.values())
    jobs = window(ctx).jobs
    stages = sorted(idle.items(), key=lambda kv: -kv[1])
    ctx.notes.append(
        "idle of the card by program stage, s a job: "
        + ", ".join(f"{name or '(none)'} {s / jobs:.4f}"
                    for name, s in stages)
        + f"; {total / jobs:.4f} in all")
    lost = idle.get(None, 0.0) + idle.get("job", 0.0)
    return 100.0 * lost / total if total else None
