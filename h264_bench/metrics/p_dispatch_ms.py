"""Host time of the program's enc.p.dispatch spans per P frame of the
window, in ms: each staged chunk's P step as launched (P core, deblocking,
packer; Python, ctypes and launches).

The spans are host events of the window's thread (run.trace.host), inside
the harness's bench.* spans and so inside the window. A program without
them reads nothing."""


def read(run):
    ns = [b - a for a, b, name in run.trace.host if name == "enc.p.dispatch"]
    if not ns or not run.p_frames:
        return None
    return sum(ns) / 1e6 / run.p_frames
