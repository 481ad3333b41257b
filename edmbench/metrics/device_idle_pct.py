"""100 x (1 - the union of the device's activity intervals over the traced
window), % (layer: the device)."""


def read(record):
    tr = record.get("trace")
    if not tr or not tr["window_ns"] or not tr["busy_ns"]:
        return None
    return 100.0 * (1.0 - tr["busy_ns"] / tr["window_ns"])
