"""Front-end seconds per mesh, over the window's finished jobs: the
harness's host-clock span around ``input.load`` and ``template.run``
(O4H blocking and TFI) plus ``smooth_mesh``'s ``PhaseTimer`` phases
``connection_check``, ``classify`` and ``solver_setup`` (the device
solver's plan, glue and uploads)."""

PHASES = ("connection_check", "classify", "solver_setup")


def read(run):
    done = run.finished()
    if not done:
        return None
    return sum((j.frontend_end - j.start)
               + sum(j.phases.get(p, 0.0) for p in PHASES)
               for j in done) / len(done)
