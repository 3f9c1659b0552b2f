"""Seconds per mesh in capturing the preconditioner's CUDA graph, over the
window's finished jobs: the program's span ``precond.graph.capture``
(inside ``precond``, around the capture and instantiation of one
preconditioner application, once for each job's smoother), which the
job's ``PhaseTimer`` totals hold. None where the program has no such
span."""

SPAN = "precond.graph.capture"


def read(run):
    done = run.finished()
    if not any(SPAN in j.phases for j in done):
        return None
    return sum(j.phases.get(SPAN, 0.0) for j in done) / len(done)
