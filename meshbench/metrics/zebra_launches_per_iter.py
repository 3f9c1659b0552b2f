"""K-A launches per Picard iteration, over the window's finished jobs:
the change in the port's counter ``ops.zebra.ZEBRA_LAUNCHES`` over the
iterations (preconditioner applications x the V-cycle's half-sweeps)."""


def read(run):
    done = run.finished()
    iters = sum(len(j.iteration_ends) for j in done)
    if not iters:
        return None
    return sum(j.zebra_launches for j in done) / iters
