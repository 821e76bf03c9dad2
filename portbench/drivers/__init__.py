"""One driver a traffic kind: run(ctx) -> the run's window, numbers and
counters."""
