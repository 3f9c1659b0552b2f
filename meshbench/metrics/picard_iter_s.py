"""Seconds per Picard iteration, over the window's jobs: the
``PhaseTimer`` phase ``picard_loop`` (each iteration ends in a host read,
so it holds the device's time) over the iterations."""


def read(run):
    done = run.finished()
    iters = sum(len(j.iteration_ends) for j in done)
    if not iters:
        return None
    return sum(j.phases.get("picard_loop", 0.0) for j in done) / iters
