"""What the reference of Main-profile CABAC with I_4x4 IDRs imports: a
fresh interpreter that loads each of its modules loads nothing of the
program and nothing of JAX or the JAX package."""

from __future__ import annotations

from h264_bench import harness
from h264_bench.tests.test_bench_imports import loaded_after


def test_cabac_reference_imports_nothing_of_the_program():
    tops = loaded_after(
        "from h264_bench.reference import encoder_main, cabac, "
        "cabac_tables, intra4")
    assert not tops & {"media_tpu_torch", *harness.FORBIDDEN}
