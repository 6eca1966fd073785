"""Host synchronisations of the device in the window, per materialisation
job (CUDA's sync debug mode, counted by the harness)."""


def read(record):
    jobs = record.counters.get("jobs")
    if record.syncs is None or not jobs:
        return None
    return record.syncs / jobs
