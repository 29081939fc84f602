"""Calls of the on-device CAVLC pack per P frame in the window: the delta
of the program's counter pack_pslice_device.launches over the P frames.
Above 1 means the adaptive stream cap overflowed and the frame was packed
again."""


def read(run):
    if not run.p_frames:
        return None
    return run.counters["pack_pslice_device.launches"] / run.p_frames
