"""Mean host time inside the benchmark's span around a plain-step call, ms
(layer: the driver, ``models/driver.py``)."""


def read(record):
    t = record["spans"].get("plain") or []
    return sum(t) / len(t) * 1e3 if t else None
