"""Host syncs the phase steps counted (``step.host_syncs``) over the
window, per stride cycle (layer: the cell host)."""


def read(record):
    return record["host_syncs"] / record["cycles"] if record["cycles"] else None
