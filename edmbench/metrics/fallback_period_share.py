"""The share of the window's rebuild periods run at full cap because the
tail list overflowed (``state.tail_fallbacks``), % (layer: the cell
host).  Nothing to read on a cell without a kernel cap."""


def read(record):
    if record.get("tail_fallbacks") is None or not record["cycles"]:
        return None
    return 100.0 * record["tail_fallbacks"] / record["cycles"]
