"""Device time of the operations launched inside hill-step spans, per
hill step, ms (layer: the engine: bias, collection, draws, deposition)."""


def read(record):
    tr = record.get("trace")
    if not tr or not tr["span_count"].get("hill") or "hill" not in tr["span_device_ns"]:
        return None
    return tr["span_device_ns"]["hill"] / tr["span_count"]["hill"] / 1e6
