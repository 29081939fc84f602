"""Frame encoder, session, P-frame core, deblocking driver, slice writers."""
