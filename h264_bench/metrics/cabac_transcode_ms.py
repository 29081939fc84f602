"""Host time of the program's enc.p.transcode spans per P frame of the
window, in ms: each P slice's device CAVLC pack re-coded as CABAC (the C++
transcoder, or the Python parse and recode where it refuses).

The spans are host events of the window's thread (run.trace.host), inside
the harness's bench.* spans and so inside the window. A program without
them reads nothing."""


def read(run):
    ns = [b - a for a, b, name in run.trace.host if name == "enc.p.transcode"]
    if not ns or not run.p_frames:
        return None
    return sum(ns) / 1e6 / run.p_frames
