"""Step builders of the port: ``make_prefill_step`` and
``make_serve_step`` (training waits for a later slice)."""
