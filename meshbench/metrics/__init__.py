"""One reader per metric: ``metrics/<name>.py`` defines ``read(run)``,
which returns the metric's number from a ``run.Run``, or None when the
run holds nothing for it to read (the harness then leaves it out)."""
