"""Serving steps over the decoder stack (``serve_step``)."""
