"""One reader per per-layer metric, found by the metric's name: each
module's ``read(record)`` returns the metric's value from the traced
run's record (``run.run_cell``), or None where there is nothing to read."""
