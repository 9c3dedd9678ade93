"""Host prep of a request: host clock from the call of ``match`` to the
first call of ``matcher.net`` (load, resize, copy), averaged over the
window's requests, in ms."""


def read(run):
    v = run.records.get("host_prep_s")
    return 1e3 * sum(v) / len(v) if v else None
