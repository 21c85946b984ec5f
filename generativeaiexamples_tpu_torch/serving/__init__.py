"""HTTP serving surface of the port: OpenAI-style ``/v1/completions`` and
``/health`` over one engine."""
