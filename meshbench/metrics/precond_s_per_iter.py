"""Host seconds per Picard iteration inside the preconditioner's
applications, over the window's finished jobs: the program's span
``precond`` (one per FGMRES iteration, around ``_stage_Minv``), which the
job's ``PhaseTimer`` totals hold, over the jobs' iterations. The span
holds no host read, so this is the time the host takes to issue the
preconditioner's work; CUDA graphs over one application would cut it.
None where the program has no such span."""


def read(run):
    done = [j for j in run.finished() if "precond" in j.phases]
    iters = sum(len(j.iteration_ends) for j in done)
    if not iters:
        return None
    return sum(j.phases["precond"] for j in done) / iters
