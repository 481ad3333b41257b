"""The least time a plain step's work needs (the kind's ``work``, each
input byte read once and each output byte written once, over the peaks of
``peaks.py``) over the device time of the operations launched inside plain-step spans, per
plain step, % (layer: the kernels).  A sharded host's step runs on
``record["ranks"]`` cards, so its least time is the whole system's over
the ranks, against rank 0's device time."""


def read(record):
    tr, w = record.get("trace"), record.get("work")
    if not tr or not w or not tr["span_count"].get("plain"):
        return None
    dev_s = tr["span_device_ns"].get("plain", 0) / tr["span_count"]["plain"] / 1e9
    least_s = w["least_s"] / record.get("ranks", 1)
    return 100.0 * least_s / dev_s if dev_s > 0 else None
