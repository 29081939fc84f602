"""The roofline yardstick's arithmetic."""

from __future__ import annotations

import pytest

from h264_bench import harness

STAGES = harness.kernel_stages()
PEAKS = {"hbm_bytes_s": 3.35e12, "int_lanes_per_sm": 64,
         "samples_per_packed_instruction": 4, "sm_count": 132,
         "max_sm_mhz": 1980.0}


def run_of(width, height, **kw):
    R, C = -(-height // 16), -(-width // 16)
    base = dict(R=R, C=C, width=width, height=height, frames=300,
                idr_frames=1, p_frames=299, au_bytes={"idr": 0, "p": 0},
                peaks=PEAKS)
    base.update(kw)
    return harness.Run(**base)


@pytest.mark.parametrize("w, h, mbs, samples, us", [
    (1920, 1080, 8160, 706_068_480, 10.55),
    (3840, 2160, 32400, 2_803_507_200, 41.9)])
def test_pcore_samples_and_bound(w, h, mbs, samples, us):
    pcore = STAGES["pcore"]
    run = run_of(w, h)
    assert run.R * run.C == mbs
    assert pcore.samples_per_frame(run.R, run.C) == samples
    # 4 samples x 64 lanes x 132 SMs x 1980 MHz = 66.9 T samples/s; the
    # samples bound the P core, not its bytes.
    assert pcore.bound_per_frame_s(run) * 1e6 == pytest.approx(us, abs=0.05)
    assert pcore.bound_s(run) == pytest.approx(
        299 * pcore.bound_per_frame_s(run))


def test_byte_bounds():
    run = run_of(1920, 1080, au_bytes={"idr": 0, "p": 299 * 20000})
    n = 8160
    assert STAGES["deblock"].bound_s(run) == pytest.approx(
        300 * (2 * n * 384 + n * 480) / 3.35e12)
    assert STAGES["cavlc_pack"].bound_s(run) == pytest.approx(
        (299 * (n * 772 + 4) + 299 * 20000) / 3.35e12)
