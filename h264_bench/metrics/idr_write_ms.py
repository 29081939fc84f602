"""Host time of the program's enc.idr.write spans per IDR of the window, in
ms: the IDR's slices written on the host (the C++ CAVLC I writer), wrapped
in NALs and prefixed with SPS, PPS and SEI.

The spans are host events of the window's thread (run.trace.host), inside
the harness's bench.* spans and so inside the window. A program without
them reads nothing."""


def read(run):
    ns = [b - a for a, b, name in run.trace.host if name == "enc.idr.write"]
    if not ns or not run.idr_frames:
        return None
    return sum(ns) / 1e6 / run.idr_frames
