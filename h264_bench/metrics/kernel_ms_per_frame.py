"""Device time of the program's own kernels (every stage of kernels/, by
profiler name) per encoded frame, in ms."""


def read(run):
    total = count = 0
    for mod in run.stages.values():
        seconds, n = run.trace.stage(mod.PATTERN)
        total, count = total + seconds, count + n
    if not count or not run.frames:
        return None
    return 1e3 * total / run.frames
