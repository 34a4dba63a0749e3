"""Index build: the host span around the program's constructor (the
server's, in served cells): ``TNKDE.__init__`` -> ``rfs.RangeForest`` and
the device engine. Seconds; moves ``setup_s``."""


def read(run):
    t = run.spans.total("build")
    return t if run.spans.times.get("build") else None
