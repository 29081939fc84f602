"""Host time of the program's enc.p.assemble spans per P frame of the
window, in ms: each chunk's access units built from its downloaded words
(slice headers, merge_slice_data, wrap_nal).

The spans are host events of the window's thread (run.trace.host), inside
the harness's bench.* spans and so inside the window. A program without
them reads nothing."""


def read(run):
    ns = [b - a for a, b, name in run.trace.host if name == "enc.p.assemble"]
    if not ns or not run.p_frames:
        return None
    return sum(ns) / 1e6 / run.p_frames
