"""Device time of NCCL's operations launched inside plain-step spans, per
plain step, on rank 0, ms (layer: the collectives, ``parallel/
collectives.py``: a sharded host's psum of the slot forces, one a plain
step).  An NCCL kernel spins on the card until every rank has joined, so
this reads the transfer plus the wait for the slowest rank.  Nothing to
read on one card."""


def read(record):
    tr = record.get("trace")
    if not tr or not tr["span_count"].get("plain") or not tr["span_nccl_ns"].get("plain"):
        return None
    return tr["span_nccl_ns"]["plain"] / tr["span_count"]["plain"] / 1e6
