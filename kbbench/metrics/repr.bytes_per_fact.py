"""Resident bytes of the materialised store per fact of its closure, at the
end of the window's last job (the program's memory accountant, which sums
what the engine, its column store and its dedup buffers report)."""


def read(record):
    facts = record.counters.get("closure_facts")
    resident = record.counters.get("resident_bytes")
    if not facts or resident is None:
        return None
    return resident / facts
