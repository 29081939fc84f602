"""Test-support utilities of the port (the third-party conformance oracle).

Nothing here is on the product path; the package exists so the tests and
chip_smoke.py can hold media_tpu_torch bitstreams to an independent codec.
The twin of media_tpu/testing.
"""
