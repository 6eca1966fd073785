"""Percent of each job spent loading (compressing the explicit facts into
meta-facts): the harness's ``job.load`` spans over ``job.load`` plus
``job.materialise``, each ending in a synchronisation of the device."""


def read(record):
    load = sum(s.dur_ns for s in record.spans if s.name == "job.load")
    mat = sum(s.dur_ns for s in record.spans if s.name == "job.materialise")
    if not load + mat:
        return None
    return 100.0 * load / (load + mat)
