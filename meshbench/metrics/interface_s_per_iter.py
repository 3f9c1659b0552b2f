"""Host seconds per Picard iteration inside the preconditioner's
interface solve, over the window's finished jobs: the program's span
``precond.interface`` (``_stage_interface``: the connection chains'
Thomas loop, a few small operations a step, and the sliding and junction
rows; three a preconditioner application by default), which the job's
``PhaseTimer`` totals hold, over the jobs' iterations. None where the
program has no such span."""


def read(run):
    done = [j for j in run.finished() if "precond.interface" in j.phases]
    iters = sum(len(j.iteration_ends) for j in done)
    if not iters:
        return None
    return sum(j.phases["precond.interface"] for j in done) / iters
